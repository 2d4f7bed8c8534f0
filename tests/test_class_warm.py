"""Class-level forecast mode: simulate(initial_state=/return_final_state=).

The ops-level warm kernels are covered by tests/test_warm_state.py; these
tests pin the class-API layer on top -- state bundles
(:mod:`rrmpg_jax.models.states`), cold-start ``return_final_state``,
warm-continuation chaining, batched-ensemble states, and the guard rails.
"""

import numpy as np
import pytest

from rrmpg_jax.models import (
    ABCModel,
    ABCState,
    Cemaneige,
    CemaneigeGR4J,
    CemaneigeGR4JIce,
    CemaneigeHystGR4J,
    CemaneigeHystGR4JIce,
    CemaneigeHystState,
    CemaneigeState,
    GR4J,
    GR4JState,
    HBVEdu,
    HBVEduState,
    SnowGR4JState,
)

from lane import tol

T = 240
SPLIT = 150
ALTS = [550, 620, 700, 785, 920]
FRAC_ICE = [0.02, 0.04, 0.25, 0.51, 0.71]


@pytest.fixture(scope="module")
def forcing():
    rng = np.random.default_rng(42)
    mt = rng.uniform(-10, 15, T)
    return {
        'prec': rng.uniform(0, 15, T),
        'mean_temp': mt,
        'min_temp': mt - rng.uniform(0, 5, T),
        'max_temp': mt + rng.uniform(0, 5, T),
        'etp': rng.uniform(0, 4, T),
        'month': rng.integers(1, 13, T),
        'pe_m': rng.uniform(1, 4, 12),
        't_m': rng.uniform(-5, 15, 12),
    }


# ---------------------------------------------------------------------------
# Exact split-invariance for the models without data-dependent precomputes:
# cold prefix (+final state) -> warm continuation == unbroken cold run.
# ---------------------------------------------------------------------------

def test_abc_split_matches_unbroken(forcing):
    model = ABCModel(params={'a': 0.3, 'b': 0.2, 'c': 0.15})
    q_full, s_full = model.simulate(forcing['prec'], initial_state=5.0,
                                    return_storage=True)
    q_a, state = model.simulate(forcing['prec'][:SPLIT], initial_state=5.0,
                                return_final_state=True)
    assert isinstance(state, ABCState)
    assert np.asarray(state.storage).shape == (1,)
    q_b, s_b = model.simulate(forcing['prec'][SPLIT:], initial_state=state,
                              return_storage=True)
    assert np.allclose(q_full[:SPLIT], q_a, rtol=tol(1e-10, 2e-3))
    assert np.allclose(q_full[SPLIT:], q_b, rtol=tol(1e-10, 2e-3))
    assert np.allclose(s_full[SPLIT:], s_b, rtol=tol(1e-10, 2e-3))


def test_gr4j_split_matches_unbroken(forcing):
    model = GR4J(params={'x1': 320., 'x2': 1.1, 'x3': 90., 'x4': 2.3})
    q_full = model.simulate(forcing['prec'], forcing['etp'], s_init=0.3,
                            r_init=0.5)
    q_a, state = model.simulate(forcing['prec'][:SPLIT],
                                forcing['etp'][:SPLIT], s_init=0.3,
                                r_init=0.5, return_final_state=True)
    assert isinstance(state, GR4JState)
    q_b = model.simulate(forcing['prec'][SPLIT:], forcing['etp'][SPLIT:],
                         initial_state=state)
    assert np.allclose(q_full[:SPLIT], q_a, rtol=tol(1e-10, 2e-3))
    assert np.allclose(q_full[SPLIT:], q_b, rtol=tol(1e-10, 2e-3), atol=tol(1e-12, 1e-4))


def test_hbv_split_matches_unbroken(forcing):
    model = HBVEdu()
    args = (forcing['mean_temp'], forcing['prec'], forcing['month'],
            forcing['pe_m'], forcing['t_m'])
    inits = dict(snow_init=2., soil_init=100., s1_init=1., s2_init=1.)
    q_full = model.simulate(*args, **inits)
    head = tuple(a[:SPLIT] if len(a) == T else a for a in args)
    tail = tuple(a[SPLIT:] if len(a) == T else a for a in args)
    q_a, state = model.simulate(*head, return_final_state=True, **inits)
    assert isinstance(state, HBVEduState)
    q_b, *storages, state2 = model.simulate(
        *tail, initial_state=state, return_storage=True,
        return_final_state=True)
    assert len(storages) == 4
    assert isinstance(state2, HBVEduState)
    assert np.allclose(q_full[:SPLIT], q_a, rtol=tol(1e-10, 2e-3))
    assert np.allclose(q_full[SPLIT:], q_b, rtol=tol(1e-10, 2e-3))


# ---------------------------------------------------------------------------
# Snow family: the snow-cover threshold is a data-dependent precompute of
# the original series, so a warm chain is compared against the one-hop warm
# continuation (not an unbroken cold run with a different threshold).
# ---------------------------------------------------------------------------

def test_cemaneige_warm_chain(forcing):
    model = Cemaneige(params={'CTG': 0.25, 'Kf': 3.74})
    kw = dict(met_station_height=495, altitudes=ALTS)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi])
    out_a, G, eTG, state = model.simulate(
        *args(0, SPLIT), return_storages=True, return_final_state=True,
        **kw)
    assert isinstance(state, CemaneigeState)
    assert np.asarray(state.g).shape == (1, len(ALTS))
    # carried threshold equals the original series' 0.9 * 365.25 * mean
    snow = None  # computed through the class's met preprocessing
    # warm one-hop vs two-hop
    one = model.simulate(*args(SPLIT, T), initial_state=state, **kw)
    mid = SPLIT + (T - SPLIT) // 2
    hop1, st_mid = model.simulate(*args(SPLIT, mid), initial_state=state,
                                  return_final_state=True, **kw)
    hop2 = model.simulate(*args(mid, T), initial_state=st_mid, **kw)
    assert np.allclose(one, np.concatenate([hop1, hop2]), rtol=tol(1e-10, 2e-3))
    # final states line up with the storage series
    assert np.allclose(np.asarray(state.g)[0], np.asarray(G)[-1, :, 0])
    assert np.allclose(np.asarray(state.etg)[0], np.asarray(eTG)[-1, :, 0])


SNOW_CASES = [
    (CemaneigeGR4J, {}, 5, CemaneigeState),
    (CemaneigeHystGR4J, {}, 7, CemaneigeHystState),
    (CemaneigeGR4JIce, {'frac_ice': FRAC_ICE}, 6, CemaneigeState),
    (CemaneigeHystGR4JIce, {'frac_ice': FRAC_ICE}, 9, CemaneigeHystState),
]


@pytest.mark.parametrize("cls,extra,n_series,snow_cls", SNOW_CASES)
def test_composition_warm_chain(forcing, cls, extra, n_series, snow_cls):
    model = cls()
    kw = dict(met_station_height=495, altitudes=ALTS, **extra)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    out = model.simulate(*args(0, SPLIT), return_storage=True,
                         return_final_state=True, **kw)
    *series, state = out
    assert len(series) == n_series
    assert isinstance(state, SnowGR4JState)
    assert isinstance(state.snow, snow_cls)
    assert isinstance(state.gr4j, GR4JState)

    # cold + return_final_state must not change the cold outputs
    plain = model.simulate(*args(0, SPLIT), return_storage=True, **kw)
    for a, b in zip(series, plain):
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=tol(1e-12, 2e-3))

    # one-hop warm == two-hop warm chain (incl. all storage series)
    one = model.simulate(*args(SPLIT, T), initial_state=state,
                         return_storage=True, **kw)
    mid = SPLIT + (T - SPLIT) // 2
    hop1 = model.simulate(*args(SPLIT, mid), initial_state=state,
                          return_storage=True, return_final_state=True,
                          **kw)
    *series1, st_mid = hop1
    series2 = model.simulate(*args(mid, T), initial_state=st_mid,
                             return_storage=True, **kw)
    assert len(one) == n_series
    for full, a, b in zip(one, series1, series2):
        assert np.allclose(np.asarray(full),
                           np.concatenate([np.asarray(a), np.asarray(b)]),
                           rtol=tol(1e-9, 2e-3), atol=tol(1e-11, 1e-4))


def test_hystice_warm_snowmelt_consistency(forcing):
    """The warm Hyst+Ice path returns the snow outflow series (the class
    contract includes it); snowmelt + weighted icemelt must feed GR4J, so
    qsim of a zero-length icemelt (frac_ice=0) equals the no-ice class."""
    kw = dict(met_station_height=495, altitudes=ALTS)
    params = CemaneigeHystGR4JIce().get_random_params()
    p_hyst = {k: float(params[k][0]) for k in
              ('CTG', 'Kf', 'Thacc', 'Rsp', 'x1', 'x2', 'x3', 'x4')}
    ice = CemaneigeHystGR4JIce(params={**p_hyst, 'DDF': 11.0})
    hyst = CemaneigeHystGR4J(params=p_hyst)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    _, st_ice = ice.simulate(*args(0, SPLIT), frac_ice=[0.0] * len(ALTS),
                             return_final_state=True, **kw)
    _, st_hyst = hyst.simulate(*args(0, SPLIT), return_final_state=True,
                               **kw)
    out_ice = ice.simulate(*args(SPLIT, T), frac_ice=[0.0] * len(ALTS),
                           initial_state=st_ice, return_storage=True, **kw)
    q_hyst = hyst.simulate(*args(SPLIT, T), initial_state=st_hyst, **kw)
    q_ice, *_, snowmelt, _ = out_ice
    icemelt = out_ice[6]
    assert np.all(np.asarray(icemelt) == 0.0)
    assert np.allclose(q_ice, q_hyst, rtol=tol(1e-10, 2e-3), atol=tol(1e-12, 1e-4))


# ---------------------------------------------------------------------------
# Batched ensembles
# ---------------------------------------------------------------------------

def test_gr4j_batched_states_match_members(forcing):
    model = GR4J()
    params = model.get_random_params(3)
    q_full = model.simulate(forcing['prec'], forcing['etp'], params=params)
    _, state = model.simulate(forcing['prec'][:SPLIT],
                              forcing['etp'][:SPLIT], params=params,
                              return_final_state=True)
    assert np.asarray(state.s).shape == (3,)
    q_b = model.simulate(forcing['prec'][SPLIT:], forcing['etp'][SPLIT:],
                         params=params, initial_state=state)
    assert np.allclose(q_full[SPLIT:], q_b, rtol=tol(1e-9, 2e-3), atol=tol(1e-10, 1e-4))
    # each member's state row equals its single-member state
    for i in range(3):
        _, st_i = model.simulate(
            forcing['prec'][:SPLIT], forcing['etp'][:SPLIT],
            params={n: params[n][i] for n in model.get_parameter_names()},
            return_final_state=True)
        assert np.allclose(np.asarray(state.s)[i], np.asarray(st_i.s)[0])
        assert np.allclose(np.asarray(state.pr_history)[i],
                           np.asarray(st_i.pr_history)[0])


def test_shared_state_broadcasts_to_batch(forcing):
    """One unbatched/1-member state may seed an N-member ensemble."""
    model = CemaneigeGR4J()
    kw = dict(met_station_height=495, altitudes=ALTS)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    _, state = model.simulate(*args(0, SPLIT), return_final_state=True,
                              **kw)
    params = model.get_random_params(4)
    q = model.simulate(*args(SPLIT, T), params=params, initial_state=state,
                       **kw)
    assert q.shape == (T - SPLIT, 4)


# ---------------------------------------------------------------------------
# Guard rails
# ---------------------------------------------------------------------------

def test_wrong_state_type_raises(forcing):
    gr4j = GR4J()
    hbv_state = HBVEduState(*(np.zeros(1),) * 4)
    with pytest.raises(TypeError, match="GR4JState"):
        gr4j.simulate(forcing['prec'], forcing['etp'],
                      initial_state=hbv_state)
    hyst = CemaneigeHystGR4J()
    plain_state = SnowGR4JState(
        snow=CemaneigeState(*(np.zeros((1, 5)),) * 3),
        gr4j=GR4JState(np.zeros(1), np.zeros(1), np.zeros((1, 20))))
    with pytest.raises(TypeError, match="CemaneigeHystState"):
        hyst.simulate(forcing['prec'], forcing['mean_temp'],
                      forcing['min_temp'], forcing['max_temp'],
                      forcing['etp'], 495, altitudes=ALTS,
                      initial_state=plain_state)


def test_state_plus_cold_inits_raises(forcing):
    model = GR4J()
    _, state = model.simulate(forcing['prec'], forcing['etp'],
                              return_final_state=True)
    with pytest.raises(ValueError, match="not both"):
        model.simulate(forcing['prec'], forcing['etp'], s_init=0.5,
                       initial_state=state)


def test_stateful_engine_guard(forcing):
    # GR4J, HBV-Edu (round 5) and the snow compositions support
    # engine='pallas' forecast mode; ABC still guards it loudly (its
    # fused kernel targets the single-series headline benchmark).
    # HBV-Edu's fused forecast mode is discharge-only, so storage
    # trajectories must still be refused.
    import jax.numpy as jnp
    with pytest.raises(ValueError, match="engine='xla'"):
        ABCModel().simulate(forcing['prec'],
                            initial_state=ABCState(
                                storage=jnp.asarray([1.0])),
                            engine="pallas")
    with pytest.raises(ValueError, match="discharge only"):
        HBVEdu().simulate(forcing['mean_temp'], forcing['prec'],
                          forcing['month'], forcing['pe_m'],
                          forcing['t_m'], return_final_state=True,
                          return_storage=True, engine="pallas")


@pytest.mark.parametrize("num", [8, 5])  # exact shard multiple + padded
def test_sharded_warm_matches_unsharded(forcing, num):
    """Mesh-sharded forecast ensembles (the probabilistic-forecast path)
    equal the unsharded run, including the returned final states and the
    padding case where N is not a multiple of the shard count."""
    from rrmpg_jax.parallel.mesh import default_mesh

    mesh = default_mesh()
    model = GR4J()
    params = model.get_random_params(num)
    q0, st0 = model.simulate(forcing['prec'][:SPLIT],
                             forcing['etp'][:SPLIT], params=params,
                             return_final_state=True)
    q1, st1 = model.simulate(forcing['prec'][:SPLIT],
                             forcing['etp'][:SPLIT], params=params,
                             return_final_state=True, mesh=mesh)
    assert np.allclose(q0, q1, rtol=tol(1e-12, 2e-3))
    for a, b in zip(st0, st1):
        assert np.asarray(b).shape == np.asarray(a).shape
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=tol(1e-12, 2e-3))

    w0 = model.simulate(forcing['prec'][SPLIT:], forcing['etp'][SPLIT:],
                        params=params, initial_state=st0)
    w1 = model.simulate(forcing['prec'][SPLIT:], forcing['etp'][SPLIT:],
                        params=params, initial_state=st1, mesh=mesh)
    assert np.allclose(w0, w1, rtol=tol(1e-12, 2e-3))


def test_sharded_warm_snow_composition(forcing):
    from rrmpg_jax.parallel.mesh import default_mesh

    mesh = default_mesh()
    model = CemaneigeGR4J()
    kw = dict(met_station_height=495, altitudes=ALTS)
    params = model.get_random_params(8)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    _, st = model.simulate(*args(0, SPLIT), params=params,
                           return_final_state=True, **kw)
    w0 = model.simulate(*args(SPLIT, T), params=params, initial_state=st,
                        **kw)
    w1 = model.simulate(*args(SPLIT, T), params=params, initial_state=st,
                        mesh=mesh, **kw)
    assert np.allclose(w0, w1, rtol=tol(1e-12, 2e-3))


def test_member_count_mismatch_raises(forcing):
    model = GR4J()
    params3 = model.get_random_params(3)
    _, state3 = model.simulate(forcing['prec'], forcing['etp'],
                               params=params3, return_final_state=True)
    params2 = model.get_random_params(2)
    with pytest.raises(ValueError, match="leading state axis"):
        model.simulate(forcing['prec'], forcing['etp'], params=params2,
                       initial_state=state3)


def test_layer_mismatch_raises(forcing):
    model = Cemaneige()
    kw = dict(met_station_height=495, altitudes=ALTS)
    _, state = model.simulate(forcing['prec'], forcing['mean_temp'],
                              forcing['min_temp'], forcing['max_temp'],
                              return_final_state=True, **kw)
    with pytest.raises(ValueError, match="elevation layer"):
        model.simulate(forcing['prec'], forcing['mean_temp'],
                       forcing['min_temp'], forcing['max_temp'], 495,
                       altitudes=ALTS[:3], initial_state=state)


def test_short_warm_history_raises(forcing):
    """A state whose UH history is shorter than the filter depth would
    silently zero-fill pre-split routed water; the ops guard must surface
    through the class API.  (States produced by the class itself always
    carry >= NUM_UH2-1 taps, so this needs a hand-built state.)"""
    model = GR4J(params={'x1': 320., 'x2': 1.1, 'x3': 90., 'x4': 2.3})
    state = GR4JState(np.zeros(1), np.zeros(1), np.zeros((1, 5)))
    with pytest.raises(ValueError, match="history taps"):
        model.simulate(forcing['prec'], forcing['etp'],
                       initial_state=state)


# ---------------------------------------------------------------------------
# Operational recalibration: fit(initial_state=)
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_gr4j_fit_from_state_recovers_truth(forcing):
    """Calibrating a continuation segment from the true carried state must
    find (near-)zero loss at the true parameters, which a cold-start fit
    of the same segment cannot (its zero-history assumption is wrong)."""
    truth = GR4J(params={'x1': 320., 'x2': 1.1, 'x3': 90., 'x4': 2.3})
    q_full, state = truth.simulate(forcing['prec'], forcing['etp'],
                                   s_init=0.4, r_init=0.6,
                                   return_final_state=False), None
    _, state = truth.simulate(forcing['prec'][:SPLIT],
                              forcing['etp'][:SPLIT], s_init=0.4,
                              r_init=0.6, return_final_state=True)
    qobs_seg = np.asarray(q_full)[SPLIT:, 0]
    model = GR4J()
    warm_fit = model.fit(qobs_seg, forcing['prec'][SPLIT:],
                         forcing['etp'][SPLIT:], initial_state=state,
                         seed=0, maxiter=40)
    assert warm_fit.fun < 1e-3
    cold_fit = model.fit(qobs_seg, forcing['prec'][SPLIT:],
                         forcing['etp'][SPLIT:], seed=0, maxiter=40)
    assert warm_fit.fun < cold_fit.fun


@pytest.mark.slow
def test_abc_and_hbv_fit_from_state(forcing):
    abc_truth = ABCModel(params={'a': 0.3, 'b': 0.2, 'c': 0.15})
    q_full, st = abc_truth.simulate(forcing['prec'], initial_state=5.0,
                                    return_final_state=True)
    _, st = abc_truth.simulate(forcing['prec'][:SPLIT], initial_state=5.0,
                               return_final_state=True)
    res = ABCModel().fit(np.asarray(q_full)[SPLIT:, 0],
                         forcing['prec'][SPLIT:], initial_state=st,
                         seed=0, maxiter=30)
    assert res.fun < 1e-4

    hbv_truth = HBVEdu()
    args = (forcing['mean_temp'], forcing['prec'], forcing['month'],
            forcing['pe_m'], forcing['t_m'])
    q_full, st = hbv_truth.simulate(*args, snow_init=2., soil_init=100.,
                                    return_final_state=True)
    head = tuple(a[:SPLIT] if len(a) == T else a for a in args)
    tail = tuple(a[SPLIT:] if len(a) == T else a for a in args)
    _, st = hbv_truth.simulate(*head, snow_init=2., soil_init=100.,
                               return_final_state=True)
    res = HBVEdu().fit(np.asarray(q_full)[SPLIT:, 0], *tail,
                       initial_state=st, seed=1, maxiter=25)
    assert np.isfinite(res.fun)


@pytest.mark.slow
def test_snow_fit_from_state(forcing):
    truth = CemaneigeGR4J()
    kw = dict(met_station_height=495, altitudes=ALTS)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    _, st = truth.simulate(*args(0, SPLIT), return_final_state=True, **kw)
    q_seg = truth.simulate(*args(SPLIT, T), initial_state=st, **kw)
    res = CemaneigeGR4J().fit(np.asarray(q_seg)[:, 0], *args(SPLIT, T),
                              initial_state=st, seed=0, maxiter=15, **kw)
    assert np.isfinite(res.fun)


def test_gr4j_warm_fit_pallas_matches_xla(forcing):
    """Operational refit rides the fused engine: fit(initial_state=,
    engine='pallas') recovers the truth like the XLA warm fit does (the
    warm objectives agree to float tolerance, so same-seed DE runs land
    on matching optima)."""
    truth = GR4J(params={'x1': 320., 'x2': 1.1, 'x3': 90., 'x4': 2.3})
    q_full = truth.simulate(forcing['prec'], forcing['etp'], s_init=0.4,
                            r_init=0.6)
    _, state = truth.simulate(forcing['prec'][:SPLIT],
                              forcing['etp'][:SPLIT], s_init=0.4,
                              r_init=0.6, return_final_state=True)
    qobs_seg = np.asarray(q_full)[SPLIT:, 0]
    fit_x = GR4J().fit(qobs_seg, forcing['prec'][SPLIT:],
                       forcing['etp'][SPLIT:], initial_state=state,
                       seed=0, maxiter=30)
    fit_p = GR4J().fit(qobs_seg, forcing['prec'][SPLIT:],
                       forcing['etp'][SPLIT:], initial_state=state,
                       seed=0, maxiter=30, engine="pallas",
                       interpret=True)
    assert fit_p.fun < 1e-3
    assert np.isclose(fit_p.fun, fit_x.fun, rtol=1e-3, atol=1e-6)
    # kge objective reaches the stats kernel on the warm path too.
    fit_k = GR4J().fit(qobs_seg, forcing['prec'][SPLIT:],
                       forcing['etp'][SPLIT:], initial_state=state,
                       seed=0, maxiter=3, engine="pallas",
                       loss_metric="kge", interpret=True)
    assert np.isfinite(fit_k.fun)


@pytest.mark.slow
def test_snow_warm_fit_pallas_matches_xla(forcing):
    """Flagship-class warm fused fit: CemaneigeHystGR4JIce
    fit(initial_state=, engine='pallas') matches the XLA warm fit."""
    truth = CemaneigeHystGR4JIce()
    kw = dict(met_station_height=495, altitudes=ALTS)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    _, st = truth.simulate(*args(0, SPLIT), FRAC_ICE,
                           return_final_state=True, **kw)
    st1 = SnowGR4JState(
        snow=CemaneigeHystState(*(np.asarray(l)[:1] for l in st.snow)),
        gr4j=GR4JState(*(np.asarray(l)[:1] for l in st.gr4j)))
    q_seg = truth.simulate(*args(SPLIT, T), FRAC_ICE, initial_state=st1,
                           **kw)
    qobs = np.asarray(q_seg)[:, 0]
    fit_x = CemaneigeHystGR4JIce().fit(
        qobs, *args(SPLIT, T), FRAC_ICE, initial_state=st1, seed=0,
        maxiter=8, **kw)
    fit_p = CemaneigeHystGR4JIce().fit(
        qobs, *args(SPLIT, T), FRAC_ICE, initial_state=st1, seed=0,
        maxiter=8, engine="pallas", interpret=True, **kw)
    assert np.isfinite(fit_p.fun)
    assert np.isclose(fit_p.fun, fit_x.fun, rtol=1e-3, atol=1e-6)



def test_fit_from_state_guards(forcing):
    model = CemaneigeGR4J()
    kw = dict(met_station_height=495, altitudes=ALTS)
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    _, st = model.simulate(*args(0, SPLIT), return_final_state=True, **kw)
    qobs = np.ones(T - SPLIT)
    with pytest.raises(ValueError, match="not both"):
        model.fit(qobs, *args(SPLIT, T), initial_state=st, s_init=0.5,
                  **kw)
    # Q+SCA calibration from a carried state stays on the XLA engine.
    hyst = CemaneigeHystGR4J()
    hkw = dict(met_station_height=495, altitudes=ALTS)
    _, hst = hyst.simulate(*args(0, SPLIT), return_final_state=True,
                           **hkw)
    ndsi = [np.full(T - SPLIT, 40.0)] * 5
    with pytest.raises(ValueError, match="engine='xla'"):
        hyst.fit_Q_SCA(qobs, *args(SPLIT, T), *ndsi, initial_state=hst,
                       engine="pallas", **hkw)

def test_fit_from_state_rejects_batched_state(forcing):
    model = GR4J()
    params = model.get_random_params(3)
    _, state3 = model.simulate(forcing['prec'], forcing['etp'],
                               params=params, return_final_state=True)
    with pytest.raises(ValueError, match="one initial condition"):
        model.fit(forcing['prec'], forcing['prec'], forcing['etp'],
                  initial_state=state3)


def test_warm_x4_beyond_state_depth_actionable_error(forcing):
    """Continuing with an x4 whose filter depth exceeds the carried
    history must raise the class-level (actionable) message, not the
    ops-level num_uh2 wording."""
    model = GR4J()
    _, state = model.simulate(forcing['prec'], forcing['etp'],
                              params={'x1': 320., 'x2': 1.1, 'x3': 90.,
                                      'x4': 2.3},
                              return_final_state=True)
    with pytest.raises(ValueError, match="history taps"):
        model.simulate(forcing['prec'], forcing['etp'],
                       params={'x1': 320., 'x2': 1.1, 'x3': 90.,
                               'x4': 12.0},
                       initial_state=state)


def test_monte_carlo_composes_with_initial_state(forcing):
    """monte_carlo forwards simulate kwargs, so an ensemble forecast from
    one carried analysis state (broadcast to all members) just works."""
    from rrmpg_jax.tools import monte_carlo

    truth = GR4J(params={'x1': 320., 'x2': 1.1, 'x3': 90., 'x4': 2.3})
    q_full, st = truth.simulate(forcing['prec'], forcing['etp'],
                                return_final_state=True)
    qobs = np.asarray(q_full)[SPLIT:, 0]
    mc = monte_carlo(GR4J(), 64, qobs=qobs, prec=forcing['prec'][SPLIT:],
                     etp=forcing['etp'][SPLIT:], initial_state=st)
    assert mc['qsim'].shape == (T - SPLIT, 64)
    assert np.isfinite(mc['mse']).any()


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_class_warm_fuzz_all_models(seed):
    """Randomized chain-consistency sweep: for every class, random
    parameters and random split points, a two-hop warm chain must equal
    the one-hop continuation (and for the stateless-precompute models,
    the unbroken run)."""
    rng = np.random.default_rng(100 + seed)
    T_f = 180
    mt = rng.uniform(-12, 18, T_f)
    forc = {
        'prec': rng.uniform(0, 18, T_f),
        'mean_temp': mt,
        'min_temp': mt - rng.uniform(0, 6, T_f),
        'max_temp': mt + rng.uniform(0, 6, T_f),
        'etp': rng.uniform(0, 5, T_f),
    }
    s0 = int(rng.integers(20, T_f - 40))
    s1 = int(rng.integers(s0 + 10, T_f - 10))

    # exact-invariance models
    abc = ABCModel()
    q_full = abc.simulate(forc['prec'])
    _, st = abc.simulate(forc['prec'][:s0], return_final_state=True)
    q_b = abc.simulate(forc['prec'][s0:], initial_state=st)
    assert np.allclose(q_full[s0:], q_b, rtol=tol(1e-9, 2e-3), atol=tol(1e-11, 1e-4))

    gr4j = GR4J()
    q_full = gr4j.simulate(forc['prec'], forc['etp'])
    _, st = gr4j.simulate(forc['prec'][:s0], forc['etp'][:s0],
                          return_final_state=True)
    q_b = gr4j.simulate(forc['prec'][s0:], forc['etp'][s0:],
                        initial_state=st)
    assert np.allclose(q_full[s0:], q_b, rtol=tol(1e-8, 2e-3), atol=tol(1e-10, 1e-4))

    # snow compositions: two-hop == one-hop warm chain
    for cls, extra in [(CemaneigeGR4J, {}), (CemaneigeHystGR4J, {}),
                       (CemaneigeGR4JIce, {'frac_ice': FRAC_ICE}),
                       (CemaneigeHystGR4JIce, {'frac_ice': FRAC_ICE})]:
        model = cls()
        kw = dict(met_station_height=495, altitudes=ALTS, **extra)
        args = lambda lo, hi: (forc['prec'][lo:hi],
                               forc['mean_temp'][lo:hi],
                               forc['min_temp'][lo:hi],
                               forc['max_temp'][lo:hi],
                               forc['etp'][lo:hi])
        _, st = model.simulate(*args(0, s0), return_final_state=True, **kw)
        one = model.simulate(*args(s0, T_f), initial_state=st, **kw)
        h1, st_mid = model.simulate(*args(s0, s1), initial_state=st,
                                    return_final_state=True, **kw)
        h2 = model.simulate(*args(s1, T_f), initial_state=st_mid, **kw)
        assert np.allclose(one, np.concatenate([h1, h2]), rtol=tol(1e-8, 2e-3),
                           atol=tol(1e-10, 1e-4)), cls.__name__


# ---------------------------------------------------------------------------
# Pallas forecast mode: engine='pallas' carries state through the fused
# kernels (stores/UH registers/snowpack enter and exit);
# parity and split-invariance against the XLA path, plus cross-engine
# state handoff.
# ---------------------------------------------------------------------------

def test_gr4j_pallas_forecast_split_invariance(forcing):
    model = GR4J()
    params = model.get_random_params(6)
    prec, etp = forcing['prec'], forcing['etp']
    q_full = model.simulate(prec, etp, params=params, engine="pallas",
                            interpret=True)
    q_a, st = model.simulate(prec[:SPLIT], etp[:SPLIT], params=params,
                             return_final_state=True, engine="pallas",
                             interpret=True)
    q_b = model.simulate(prec[SPLIT:], etp[SPLIT:], params=params,
                         initial_state=st, engine="pallas",
                         interpret=True)
    assert np.allclose(np.concatenate([q_a, q_b]), q_full,
                       rtol=tol(1e-9, 2e-3), atol=tol(1e-11, 1e-4))
    # cross-engine handoff in both directions: the bundles are identical
    # objects, so a pallas-produced state continues on xla and vice versa.
    q_b_x = model.simulate(prec[SPLIT:], etp[SPLIT:], params=params,
                           initial_state=st)
    assert np.allclose(q_b, q_b_x, rtol=tol(1e-8, 2e-3),
                       atol=tol(1e-10, 1e-4))
    _, st_x = model.simulate(prec[:SPLIT], etp[:SPLIT], params=params,
                             return_final_state=True)
    q_b_p = model.simulate(prec[SPLIT:], etp[SPLIT:], params=params,
                           initial_state=st_x, engine="pallas",
                           interpret=True)
    assert np.allclose(q_b_p, q_b_x, rtol=tol(1e-8, 2e-3),
                       atol=tol(1e-10, 1e-4))


def test_gr4j_pallas_forecast_guards(forcing):
    model = GR4J()
    prec, etp = forcing['prec'][:40], forcing['etp'][:40]
    with pytest.raises(ValueError, match="discharge only"):
        model.simulate(prec, etp, return_storage=True,
                       return_final_state=True, engine="pallas",
                       interpret=True)
    with pytest.raises(ValueError, match="mesh"):
        import jax
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()[:1]), ("ensemble",))
        model.simulate(prec, etp, return_final_state=True,
                       engine="pallas", interpret=True, mesh=mesh)


@pytest.mark.parametrize("cls,extra,n_series,snow_cls", SNOW_CASES)
def test_composition_pallas_forecast(forcing, cls, extra, n_series,
                                     snow_cls):
    """Fused-kernel forecast mode of the four compositions: cold final
    state matches XLA leaf-for-leaf, and the warm continuation from one
    shared state agrees across engines (split-invariance by transitivity
    with test_composition_warm_chain)."""
    model = cls()
    params = model.get_random_params(3)
    kw = dict(met_station_height=495, altitudes=ALTS, **extra)
    T_s = 120
    half = T_s // 2
    args = lambda lo, hi: (forcing['prec'][lo:hi],
                           forcing['mean_temp'][lo:hi],
                           forcing['min_temp'][lo:hi],
                           forcing['max_temp'][lo:hi],
                           forcing['etp'][lo:hi])
    q_x, st_x = model.simulate(*args(0, half), params=params,
                               return_final_state=True, **kw)
    q_p, st_p = model.simulate(*args(0, half), params=params,
                               return_final_state=True, engine="pallas",
                               interpret=True, **kw)
    assert np.allclose(q_x, q_p, rtol=tol(1e-9, 2e-3),
                       atol=tol(1e-11, 1e-4))
    assert isinstance(st_p, SnowGR4JState)
    assert isinstance(st_p.snow, snow_cls)
    import jax
    for a, b in zip(jax.tree.leaves(st_x), jax.tree.leaves(st_p)):
        assert np.allclose(np.asarray(a), np.asarray(b),
                           rtol=tol(1e-9, 2e-3), atol=tol(1e-11, 1e-4))
    # warm continuation from the SAME (xla) state, both engines
    q2_x = model.simulate(*args(half, T_s), params=params,
                          initial_state=st_x, **kw)
    q2_p = model.simulate(*args(half, T_s), params=params,
                          initial_state=st_x, engine="pallas",
                          interpret=True, **kw)
    assert np.allclose(q2_x, q2_p, rtol=tol(1e-9, 2e-3),
                       atol=tol(1e-11, 1e-4))
