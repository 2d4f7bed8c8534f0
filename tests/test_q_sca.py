"""Multi-objective Q+SCA calibration tests.

Covers the XLA path of ``fit_Q_SCA`` (loss definition parity, reference
weighting 0.75 / 5 x 0.05) and the fused sufficient-statistics variant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lane import tol

from rrmpg_jax.models import CemaneigeHystGR4J
from rrmpg_jax.ops import run_cemaneigehystgr4jice
from rrmpg_jax.ops.pallas_snow import (
    q_sca_loss_from_stats,
    snowgr4j_ensemble_mse_pallas,
)
from rrmpg_jax.utils.metrics import kge as jkge
from rrmpg_jax.utils.metrics import mse as jmse


def _synthetic(T=240, seed=11):
    rng = np.random.default_rng(seed)
    prec = rng.uniform(0, 12, T)
    mean_t = rng.uniform(-8, 12, T)
    return (prec, mean_t, mean_t - 2, mean_t + 2,
            rng.uniform(0, 3, T), rng.uniform(0, 3, T),
            [rng.uniform(0, 100, T) for _ in range(5)])


@pytest.mark.slow
def test_fit_q_sca_xla_smoke():
    prec, mean_t, min_t, max_t, etp, qobs, ndsi = _synthetic()
    model = CemaneigeHystGR4J()
    res = model.fit_Q_SCA(qobs, prec, mean_t, min_t, max_t, etp, *ndsi,
                          met_station_height=700,
                          altitudes=[550, 620, 700, 785, 920],
                          seed=0, maxiter=3, tol=0.0)
    assert res.nit == 3
    assert np.isfinite(res.fun)
    assert res.x.shape == (8,)


def test_fit_q_sca_rejects_bad_metric():
    prec, mean_t, min_t, max_t, etp, qobs, ndsi = _synthetic()
    with pytest.raises(ValueError):
        CemaneigeHystGR4J().fit_Q_SCA(
            qobs, prec, mean_t, min_t, max_t, etp, *ndsi,
            met_station_height=700, loss_metric="nash")
    # The fused Q+SCA statistics path supports mse/kge only ('nse' is
    # accepted on the xla path since the loss widening).
    with pytest.raises(ValueError, match="loss_metric"):
        CemaneigeHystGR4J().fit_Q_SCA(
            qobs, prec, mean_t, min_t, max_t, etp, *ndsi,
            met_station_height=700, loss_metric="nse",
            engine="pallas", interpret=True)


@pytest.mark.slow
def test_q_sca_stats_match_trajectory_loss():
    rng = np.random.default_rng(7)
    T, L, N = 150, 5, 1024
    prec = jnp.asarray(rng.uniform(0, 15, (T, L)))
    temp = jnp.asarray(rng.uniform(-12, 18, (T, L)))
    frac = jnp.asarray(np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1))
    etp = jnp.asarray(rng.uniform(0, 4, T))
    qobs = jnp.asarray(rng.uniform(1, 5, T))
    ndsi = jnp.asarray(rng.uniform(0, 100, (L, T)))
    frac_ice = jnp.asarray(rng.uniform(0, 0.7, L))
    params = {k: jnp.asarray(v) for k, v in {
        'CTG': rng.uniform(0, 1, N), 'Kf': rng.uniform(0, 10, N),
        'Thacc': rng.uniform(1, 100, N), 'Rsp': rng.uniform(0, 1, N),
        'x1': rng.uniform(10, 1200, N), 'x2': rng.uniform(-5, 3, N),
        'x3': rng.uniform(20, 5000, N), 'x4': rng.uniform(1.1, 9.9, N),
        'DDF': rng.uniform(0, 30, N)}.items()}

    stats = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 2.0, -1.0, 0.4, 0.3, params,
        frac_ice=frac_ice, ndsi=ndsi, hyst=True, ice=True, sca_stats=True,
        interpret=True)
    assert stats.shape == (4 + 4 * L, N)

    outs = jax.vmap(lambda p: run_cemaneigehystgr4jice(
        prec, temp, etp, frac_ice, frac, 2.0, -1.0, 0.0, 0.4, 0.3,
        p))(params)
    q_x, sca_x = outs[0], outs[5]

    # MSE weighting parity (exact).
    ref_mse = 0.75 * jmse(qobs[None, :], q_x, axis=-1)
    for l in range(L):
        ref_mse += 0.05 * jmse(ndsi[l][None, :], 100 * sca_x[:, :, l],
                               axis=-1)
    got = q_sca_loss_from_stats(stats, qobs, ndsi, loss_metric="mse")
    assert np.allclose(np.asarray(got), np.asarray(ref_mse),
                       rtol=tol(1e-5, 1e-3), atol=tol(1e-8, 1e-4))

    # KGE weighting parity on non-degenerate members (constant-SCA
    # candidates are NaN in both formulations, modulo 0/0 edge patterns).
    ref_kge = 0.75 * (1 - jkge(qobs[None, :], q_x, axis=-1))
    for l in range(L):
        ref_kge += 0.05 * (1 - jkge(ndsi[l][None, :],
                                    100 * sca_x[:, :, l], axis=-1))
    got = np.asarray(q_sca_loss_from_stats(stats, qobs, ndsi,
                                           loss_metric="kge"))
    ref_kge = np.asarray(ref_kge)
    mask = np.isfinite(ref_kge) & np.isfinite(got)
    assert mask.sum() > 0.9 * N
    assert np.allclose(got[mask], ref_kge[mask],
                       rtol=tol(1e-5, 3e-3), atol=tol(1e-8, 1e-3))


@pytest.mark.slow
def test_fit_q_sca_pallas_interpret_smoke():
    # Class-level plumbing of engine='pallas' + interpret= through
    # fit_Q_SCA (CPU CI coverage of the fused multi-objective path).
    rng = np.random.default_rng(7)
    T, L = 180, 2
    mean_t = rng.uniform(-8, 15, T)
    ndsi = [rng.uniform(0, 100, T) for _ in range(L * 0 + 5)]
    m = CemaneigeHystGR4J()
    res = m.fit_Q_SCA(
        rng.uniform(0, 5, T), rng.uniform(0, 20, T), mean_t,
        mean_t - 2.0, mean_t + 2.0, rng.uniform(0, 4, T), *ndsi,
        met_station_height=495.0,
        altitudes=[550., 620., 700., 785., 920.],
        loss_metric="kge", seed=0, maxiter=2, engine="pallas",
        interpret=True)
    assert np.isfinite(res.fun)


@pytest.mark.slow
def test_composition_fit_pallas_interpret_smoke():
    from rrmpg_jax.models import CemaneigeGR4JIce

    rng = np.random.default_rng(8)
    T = 150
    mean_t = rng.uniform(-8, 15, T)
    m = CemaneigeGR4JIce()
    res = m.fit(
        rng.uniform(0, 5, T), rng.uniform(0, 20, T), mean_t,
        mean_t - 2.0, mean_t + 2.0, rng.uniform(0, 4, T),
        np.asarray([0.1, 0.2, 0.3, 0.4, 0.5]),
        met_station_height=495.0,
        altitudes=[550., 620., 700., 785., 920.],
        seed=0, maxiter=2, engine="pallas", interpret=True)
    assert np.isfinite(res.fun)


@pytest.mark.slow
def test_fit_q_sca_masked_gaps_pallas_matches_xla():
    """Q+SCA calibration on gapped observations: NaNs in the discharge
    AND in individual NDSI bands (realistic MODIS cloud gaps) are masked
    per series on both engines, which must agree generation-for-
    generation."""
    prec, mean_t, min_t, max_t, etp, qobs, ndsi = _synthetic(seed=23)
    rng = np.random.default_rng(5)
    qobs = qobs.copy()
    qobs[rng.choice(len(qobs), 30, replace=False)] = np.nan
    ndsi = [b.copy() for b in ndsi]
    ndsi[1][rng.choice(len(qobs), 60, replace=False)] = np.nan
    ndsi[4][rng.choice(len(qobs), 15, replace=False)] = np.nan

    model = CemaneigeHystGR4J()
    kw = dict(met_station_height=700,
              altitudes=[550, 620, 700, 785, 920], seed=0, maxiter=2,
              tol=0.0)
    res_x = model.fit_Q_SCA(qobs, prec, mean_t, min_t, max_t, etp,
                            *ndsi, engine="xla", **kw)
    res_p = model.fit_Q_SCA(qobs, prec, mean_t, min_t, max_t, etp,
                            *ndsi, engine="pallas", interpret=True,
                            **kw)
    assert np.isfinite(res_x.fun) and np.isfinite(res_p.fun)
    np.testing.assert_allclose(res_p.fun, res_x.fun,
                               rtol=tol(1e-8, 2e-3))
    np.testing.assert_allclose(res_p.x, res_x.x, rtol=tol(1e-6, 1e-2),
                               atol=tol(1e-8, 1e-3))


@pytest.mark.slow
def test_fit_q_sca_masked_kge_finite():
    # KGE variant on gapped series: the per-band sufficient statistics
    # renormalize over each band's own valid count.
    prec, mean_t, min_t, max_t, etp, qobs, ndsi = _synthetic(seed=29)
    rng = np.random.default_rng(6)
    qobs = qobs.copy()
    qobs[rng.choice(len(qobs), 20, replace=False)] = np.nan
    ndsi = [b.copy() for b in ndsi]
    ndsi[0][rng.choice(len(qobs), 40, replace=False)] = np.nan

    model = CemaneigeHystGR4J()
    kw = dict(met_station_height=700,
              altitudes=[550, 620, 700, 785, 920], seed=0, maxiter=2,
              tol=0.0, loss_metric="kge")
    res_x = model.fit_Q_SCA(qobs, prec, mean_t, min_t, max_t, etp,
                            *ndsi, engine="xla", **kw)
    res_p = model.fit_Q_SCA(qobs, prec, mean_t, min_t, max_t, etp,
                            *ndsi, engine="pallas", interpret=True,
                            **kw)
    assert np.isfinite(res_x.fun) and np.isfinite(res_p.fun)
    np.testing.assert_allclose(res_p.fun, res_x.fun,
                               rtol=tol(1e-7, 5e-3))
