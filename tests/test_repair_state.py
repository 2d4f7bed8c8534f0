"""Physical-domain repair of carried states.

Round 2's driver artifact went red because an EnKF analysis pushed a
GR4J routing store negative and the warm continuation evaluated
``x2 * (r / x3)**3.5`` on a negative base -> NaN.  These tests pin the
defined behavior: analysis states are repaired into their physical
domain by default, and ``simulate(initial_state=)`` clamps unphysical
carries at entry instead of propagating silent NaN.

These tests are dtype-agnostic on purpose -- they must catch the
regression in BOTH the x64 lane and the RRMPG_TEST_DTYPE=float32 lane
(the driver's production precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.models import (
    ABCModel,
    ABCState,
    CemaneigeHystGR4JIce,
    CemaneigeHystState,
    CemaneigeState,
    GR4J,
    GR4JState,
    HBVEduState,
    SnowGR4JState,
    repair_state,
)
from rrmpg_jax.models.states import is_repairable
from rrmpg_jax.tools.assimilation import enkf_update, perturb_state


def _alpine_kwargs():
    return dict(met_station_height=495,
                altitudes=[550, 620, 700, 785, 920],
                frac_ice=[0.1, 0.2, 0.3, 0.4, 0.5])


def _forcings(T, seed=5):
    rng = np.random.default_rng(seed)
    mt = rng.uniform(-10, 15, T)
    return (rng.uniform(0, 15, T), mt, mt - 2.0, mt + 2.0,
            rng.uniform(0, 4, T))


class TestRepairState:
    def test_clips_every_field_into_domain(self):
        st = CemaneigeHystState(
            g=jnp.asarray([[-3.0, 5.0]]),
            etg=jnp.asarray([[1.5, -2.0]]),
            sca=jnp.asarray([[-0.2, 1.7]]),
            swe_max=jnp.asarray([[-1.0, 2.0]]),
            psol_annual=jnp.asarray([[-4.0, 8.0]]))
        rep = repair_state(st)
        np.testing.assert_array_equal(rep.g, [[0.0, 5.0]])
        np.testing.assert_array_equal(rep.etg, [[0.0, -2.0]])
        np.testing.assert_array_equal(rep.sca, [[0.0, 1.0]])
        # swe_max clipped >= 0 AND restored >= g.
        np.testing.assert_array_equal(rep.swe_max, [[0.0, 5.0]])
        np.testing.assert_array_equal(rep.psol_annual, [[0.0, 8.0]])

    def test_identity_on_physical_state(self):
        st = GR4JState(s=jnp.asarray([120.0]), r=jnp.asarray([35.0]),
                       pr_history=jnp.asarray([[0.1, 0.0, 2.0]]))
        rep = repair_state(st)
        for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(rep)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_nested_and_simple_bundles(self):
        st = SnowGR4JState(
            snow=CemaneigeState(g=jnp.asarray([[-1.0]]),
                                etg=jnp.asarray([[0.5]]),
                                g_thresh=jnp.asarray([[9.0]])),
            gr4j=GR4JState(s=jnp.asarray([-2.0]), r=jnp.asarray([-61.2]),
                           pr_history=jnp.asarray([[-0.5, 1.0]])))
        rep = repair_state(st)
        assert float(rep.snow.g[0, 0]) == 0.0
        assert float(rep.snow.etg[0, 0]) == 0.0
        assert float(rep.gr4j.s[0]) == 0.0
        assert float(rep.gr4j.r[0]) == 0.0
        np.testing.assert_array_equal(rep.gr4j.pr_history, [[0.0, 1.0]])
        ab = repair_state(ABCState(storage=jnp.asarray([-7.0])))
        assert float(ab.storage[0]) == 0.0
        hb = repair_state(HBVEduState(*(jnp.asarray([-1.0]),) * 4))
        assert all(float(leaf[0]) == 0.0 for leaf in hb)

    def test_none_passthrough_and_unknown_type(self):
        assert repair_state(None) is None
        with pytest.raises(TypeError, match="physical domain"):
            repair_state((jnp.zeros(3), jnp.ones(3)))
        assert is_repairable(ABCState(storage=jnp.zeros(2)))
        assert not is_repairable({"x": jnp.zeros(2)})


class TestWarmEntryClamping:
    """simulate(initial_state=) must clamp unphysical carries at entry
    clipped physics, never silent NaN."""

    def test_gr4j_negative_routing_store_is_clamped(self):
        model = GR4J(params={'x1': 100.0, 'x2': -2.0, 'x3': 50.0,
                             'x4': 2.5})
        T = 40
        rng = np.random.default_rng(0)
        prec, etp = rng.uniform(0, 10, T), rng.uniform(0, 4, T)
        _, state = model.simulate(prec, etp, return_final_state=True)
        bad = state._replace(r=jnp.full_like(state.r, -61.2),
                             s=jnp.full_like(state.s, -5.0))
        q_bad = model.simulate(prec, etp, initial_state=bad)
        assert np.isfinite(np.asarray(q_bad)).all()
        # Defined behavior: identical to continuing from the clipped
        # state.
        q_clip = model.simulate(prec, etp, initial_state=repair_state(bad))
        np.testing.assert_array_equal(np.asarray(q_bad),
                                      np.asarray(q_clip))

    def test_flagship_negative_stores_are_clamped(self):
        model = CemaneigeHystGR4JIce()
        params = model.get_random_params(3)
        forc = _forcings(24)
        kw = _alpine_kwargs()
        _, state = model.simulate(*forc, params=params,
                                  return_final_state=True, **kw)
        bad = SnowGR4JState(
            snow=state.snow._replace(
                g=state.snow.g - 50.0,
                swe_max=jnp.full_like(state.snow.swe_max, -3.0),
                sca=state.snow.sca + 2.0),
            gr4j=state.gr4j._replace(r=state.gr4j.r - 100.0))
        q = model.simulate(*forc, params=params, initial_state=bad, **kw)
        assert np.isfinite(np.asarray(q)).all()

    def test_fit_from_state_clamps(self):
        model = ABCModel()
        T = 30
        rng = np.random.default_rng(1)
        prec = rng.uniform(0, 10, T)
        qobs = rng.uniform(0, 5, T)
        bad = ABCState(storage=jnp.asarray(-40.0))
        res = model.fit(qobs, prec, initial_state=bad, seed=0,
                        maxiter=3, popsize=4)
        assert np.isfinite(res.fun)


class TestEnKFDefaultRepair:
    """The round-2 regression reproducer: an EnKF analysis that pushes
    stores negative must yield a finite warm continuation BY DEFAULT."""

    def test_analysis_state_continues_finite(self):
        model = CemaneigeHystGR4JIce()
        n = 8
        params = model.get_random_params(n)
        forc = _forcings(24)
        kw = _alpine_kwargs()
        half = tuple(a[:12] for a in forc)
        rest = tuple(a[12:] for a in forc)
        q_a, state = model.simulate(*half, params=params,
                                    return_final_state=True, **kw)
        y_pred = jnp.asarray(np.asarray(q_a)[-1])
        # An observation far below the prediction drags stores down
        # hard -- the scenario that produced the round-2 negative
        # routing store.  Large inflation amplifies the pull.
        astate = enkf_update(state, y_pred,
                             float(np.asarray(y_pred).mean()) - 50.0,
                             0.01, jax.random.PRNGKey(0), inflation=5.0)
        # Default postprocess repaired the analysis into the domain...
        assert np.asarray(astate.gr4j.r).min() >= 0.0
        assert np.asarray(astate.snow.g).min() >= 0.0
        assert np.asarray(astate.snow.sca).min() >= 0.0
        assert np.asarray(astate.snow.sca).max() <= 1.0
        assert (np.asarray(astate.snow.swe_max)
                >= np.asarray(astate.snow.g)).all()
        # ...so the warm continuation is finite.
        q_c = model.simulate(*rest, params=params, initial_state=astate,
                             **kw)
        assert np.isfinite(np.asarray(q_c)).all()

    def test_explicit_none_opts_out(self):
        model = GR4J(params={'x1': 100.0, 'x2': -2.0, 'x3': 50.0,
                             'x4': 2.5})
        T = 20
        rng = np.random.default_rng(3)
        prec, etp = rng.uniform(0, 10, T), rng.uniform(0, 4, T)
        params = model.get_random_params(6)
        _, state = model.simulate(prec, etp, params=params,
                                  return_final_state=True)
        state = perturb_state(state, jax.random.PRNGKey(1), rel_std=0.4)
        # Observe the routing store itself: the gain then maps the
        # far-below-domain observation straight onto r.
        y_pred = jnp.asarray(state.r)
        kw = dict(predicted=y_pred, obs=-80.0, obs_std=0.01,
                  key=jax.random.PRNGKey(0))
        raw = enkf_update(state, postprocess=None, **kw)
        rep = enkf_update(state, **kw)
        # The raw analysis genuinely leaves the domain in this setup
        # (else the opt-out assertion below is vacuous)...
        assert np.asarray(raw.r).min() < 0.0
        # ...and the default equals repairing the raw analysis.
        for a, b in zip(jax.tree.leaves(repair_state(raw)),
                        jax.tree.leaves(rep)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_frozen_constants_survive_repair(self):
        model = CemaneigeHystGR4JIce()
        params = model.get_random_params(4)
        forc = _forcings(16)
        kw = _alpine_kwargs()
        q, state = model.simulate(*forc, params=params,
                                  return_final_state=True, **kw)
        y_pred = jnp.asarray(np.asarray(q)[-1])
        astate = enkf_update(state, y_pred, 1.0, 0.1,
                             jax.random.PRNGKey(0))
        np.testing.assert_array_equal(np.asarray(astate.snow.psol_annual),
                                      np.asarray(state.snow.psol_annual))
