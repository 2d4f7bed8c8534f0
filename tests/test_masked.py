"""Missing-observation (NaN / CAMELS -999) masking.

Real CAMELS ``*_05_model_output.txt`` files encode missing discharge as
``-999``.  The loader converts sentinels to NaN; the metrics, the XLA
objectives, and the fused Pallas kernels (``masked=True``) all exclude
NaN observations and normalize over the valid steps -- validated here
against hand-computed valid-subset results.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lane import tol

from rrmpg_jax.utils import metrics as M


def _gapped(T=300, gaps=40, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.1, 8.0, T)
    sim = obs + rng.normal(0, 0.5, T)
    idx = rng.choice(T, gaps, replace=False)
    obs_g = obs.copy()
    obs_g[idx] = np.nan
    valid = np.isfinite(obs_g)
    return obs_g, sim, valid


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def test_masked_jittable_metrics_match_valid_subset():
    obs_g, sim, valid = _gapped()
    o, s = obs_g[valid], sim[valid]
    pairs = [
        (M.mse, np.mean((o - s) ** 2)),
        (M.rmse, np.sqrt(np.mean((o - s) ** 2))),
        (M.nse, 1 - np.sum((s - o) ** 2) / np.sum((o - o.mean()) ** 2)),
        (M.pearson_r, np.corrcoef(o, s)[0, 1]),
        (M.alpha_nse, np.std(s) / np.std(o)),
        (M.beta_nse, (s.mean() - o.mean()) / np.std(o)),
        (M.kge, 1 - np.sqrt((np.corrcoef(o, s)[0, 1] - 1) ** 2 +
                            (np.std(s) / np.std(o) - 1) ** 2 +
                            (s.mean() / o.mean() - 1) ** 2)),
    ]
    for fn, expected in pairs:
        got = float(fn(obs_g, sim))
        # beta_nse is near zero here, so the f32 lane needs an atol.
        assert np.isclose(got, expected, rtol=tol(1e-12, 1e-5),
                          atol=tol(0.0, 1e-6)), fn.__name__


def test_gapfree_metrics_unchanged():
    # With no gaps the masked forms reduce to the plain formulas.
    rng = np.random.default_rng(3)
    obs = rng.uniform(0.1, 8.0, 200)
    sim = obs + rng.normal(0, 0.5, 200)
    assert np.isclose(float(M.mse(obs, sim)),
                      float(np.mean((obs - sim) ** 2)), rtol=1e-12)
    assert np.isclose(float(M.kge(obs, sim)),
                      M.calc_kge(obs, sim), rtol=tol(1e-9, 1e-5))


def test_masked_metrics_batched():
    obs_g, sim, valid = _gapped()
    batch = np.stack([sim, sim * 1.1, sim * 0.9])
    got = np.asarray(M.mse(obs_g[None, :], batch))
    for i in range(3):
        exp = np.mean((obs_g[valid] - batch[i][valid]) ** 2)
        assert np.isclose(got[i], exp, rtol=tol(1e-12, 1e-5))


def test_calc_wrappers_mask_gaps():
    obs_g, sim, valid = _gapped(seed=1)
    o, s = obs_g[valid], sim[valid]
    assert np.isclose(M.calc_mse(obs_g, sim), np.mean((o - s) ** 2))
    assert np.isclose(M.calc_nse(obs_g, sim),
                      1 - np.sum((s - o) ** 2) /
                      np.sum((o - o.mean()) ** 2))
    with pytest.raises(RuntimeError):
        M.calc_mse(np.full(10, np.nan), np.ones(10))


def test_sim_nan_still_propagates():
    # A diverged member must poison its loss, not hide in the mask.
    obs = np.ones(50)
    obs[0] = 2.0  # nonconstant
    sim = np.ones(50)
    sim[3] = np.nan
    assert np.isnan(float(M.mse(obs, sim)))


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

def _write_camels_basin(directory, basin, T=800, q_sentinel_rows=(),
                        start="1980-01-01"):
    """Minimal CAMELS-format file pair with optional -999 discharge."""
    import pandas as pd

    rng = np.random.default_rng(hash(basin) % 2 ** 31)
    dates = pd.date_range(start, periods=T, freq="D")
    met = directory / f"{basin}_lump_cida_forcing_leap.txt"
    flow = directory / f"{basin}_05_model_output.txt"
    with open(met, "w") as f:
        f.write("lat 45.0\n318.0\n1000000\n")
        f.write("Year Mnth Day Hr dayl(s) prcp(mm/day) srad(W/m2) "
                "swe(mm) tmax(C) tmin(C) vp(Pa)\n")
        for d in dates:
            p = rng.uniform(0, 12)
            f.write(f"{d.year} {d.month} {d.day} 12 43200 {p:.2f} 200 0 "
                    f"{rng.uniform(5, 25):.2f} {rng.uniform(-5, 5):.2f} "
                    "800\n")
    with open(flow, "w") as f:
        f.write("YR MNTH DY HR SWE PRCP RAIM TAIR PET ET MOD_RUN "
                "OBS_RUN\n")
        for i, d in enumerate(dates):
            q = -999.0 if i in q_sentinel_rows else rng.uniform(0.1, 5)
            f.write(f"{d.year} {d.month} {d.day} 12 0 0 0 10 "
                    f"{rng.uniform(0, 4):.2f} 1 1 {q:.2f}\n")


def test_loader_masks_sentinels(tmp_path):
    from rrmpg_jax.data import CAMELSLoader

    # Sentinels inside the hydrological-year window (row >= Oct 1 1980).
    _write_camels_basin(tmp_path, "02002000", T=800,
                        q_sentinel_rows=(300, 301, 555))
    loader = CAMELSLoader(data_dir=tmp_path)
    df = loader.load_basin("02002000")
    q = df["QObs(mm/d)"].to_numpy()
    assert np.isnan(q).sum() == 3
    assert np.nanmin(q) >= 0


def test_load_basins_outer_join_pads_observations(tmp_path):
    from rrmpg_jax.data import CAMELSLoader

    # Same forcing period, but basin B's discharge has in-record gaps.
    _write_camels_basin(tmp_path, "02002000", T=800)
    _write_camels_basin(tmp_path, "02002001", T=800,
                        q_sentinel_rows=tuple(range(400, 460)))
    loader = CAMELSLoader(data_dir=tmp_path)
    index, arrays = loader.load_basins(["02002000", "02002001"],
                                       join="outer")
    q = arrays["QObs(mm/d)"]
    assert q.shape[0] == 2
    assert np.isfinite(q[0]).all()
    assert np.isnan(q[1]).sum() == 60
    # Forcing stays gap-free.
    assert np.isfinite(arrays["prcp(mm/day)"]).all()


def test_load_basins_outer_join_rejects_forcing_gaps(tmp_path):
    from rrmpg_jax.data import CAMELSLoader

    # Basin B starts 200 days later: outer join must refuse to pad the
    # forcing columns with NaN.
    _write_camels_basin(tmp_path, "02002000", T=800)
    _write_camels_basin(tmp_path, "02002001", T=800,
                        start="1980-07-19")
    loader = CAMELSLoader(data_dir=tmp_path)
    with pytest.raises(ValueError, match="forcing"):
        loader.load_basins(["02002000", "02002001"], join="outer")
    # The observation column alone is fine.
    index, arrays = loader.load_basins(
        ["02002000", "02002001"], columns=["QObs(mm/d)"], join="outer")
    assert np.isnan(arrays["QObs(mm/d)"]).any()


# ---------------------------------------------------------------------------
# Fused kernels (interpret mode)
# ---------------------------------------------------------------------------

def _gr4j_inputs(T=250, N=6, gaps=30, seed=4):
    rng = np.random.default_rng(seed)
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    qobs = rng.uniform(0, 5, T)
    qobs[rng.choice(T, gaps, replace=False)] = np.nan
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    return prec, etp, qobs, params


def test_gr4j_fused_masked_matches_xla():
    from rrmpg_jax.ops.gr4j import run_gr4j
    from rrmpg_jax.ops.pallas_gr4j import gr4j_ensemble_mse_pallas

    prec, etp, qobs, params = _gr4j_inputs()
    losses = gr4j_ensemble_mse_pallas(
        prec, etp, qobs, 0.3, 0.3, params, num_uh1=3,
        num_uh2=7, interpret=True, masked=True)
    valid = np.isfinite(qobs)
    for i in range(losses.shape[0]):
        p = {k: float(v[i]) for k, v in params.items()}
        q = np.asarray(run_gr4j(prec, etp, 0.3, 0.3, p)[0])
        exp = np.mean((q[valid] - qobs[valid]) ** 2)
        assert np.isclose(float(losses[i]), exp, rtol=tol(1e-9, 5e-3))


def test_gr4j_fused_masked_stats_metrics():
    from rrmpg_jax.ops.gr4j import run_gr4j
    from rrmpg_jax.ops.pallas_gr4j import gr4j_ensemble_mse_pallas
    from rrmpg_jax.ops.pallas_snow import losses_from_stats

    prec, etp, qobs, params = _gr4j_inputs(seed=5)
    stats = gr4j_ensemble_mse_pallas(
        prec, etp, qobs, 0.3, 0.3, params, num_uh1=3,
        num_uh2=7, interpret=True, stats=True, masked=True)
    got = losses_from_stats(stats, jnp.asarray(qobs))
    valid = np.isfinite(qobs)
    i = 2
    p = {k: float(v[i]) for k, v in params.items()}
    q = np.asarray(run_gr4j(prec, etp, 0.3, 0.3, p)[0])
    o, s = qobs[valid], q[valid]
    exp_kge = 1 - np.sqrt((np.corrcoef(o, s)[0, 1] - 1) ** 2 +
                          (np.std(s) / np.std(o) - 1) ** 2 +
                          (s.mean() / o.mean() - 1) ** 2)
    exp_nse = 1 - np.sum((s - o) ** 2) / np.sum((o - o.mean()) ** 2)
    assert np.isclose(float(got['kge'][i]), exp_kge, rtol=tol(1e-6, 5e-3))
    assert np.isclose(float(got['nse'][i]), exp_nse, rtol=tol(1e-6, 5e-3))


def test_gr4j_regional_masked_ragged_records():
    # Two catchments whose discharge records differ in length (NaN
    # padding) plus in-record gaps: per-catchment valid-count
    # normalization.
    from rrmpg_jax.ops.gr4j import run_gr4j
    from rrmpg_jax.parallel.regional import regional_gr4j_objective

    rng = np.random.default_rng(6)
    C, T, N = 2, 220, 5
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0, 5, (C, T))
    qobs[0, 180:] = np.nan                     # shorter record
    qobs[1, rng.choice(T, 25, replace=False)] = np.nan  # gaps
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    for engine, kw in (("xla", {}),
                       ("pallas", dict(interpret=True, 
                                       num_uh1=3, num_uh2=7))):
        losses = np.asarray(regional_gr4j_objective(
            prec, etp, qobs, 0.3, 0.3, params, engine=engine, **kw))
        assert np.isfinite(losses).all(), engine
        for c in range(C):
            valid = np.isfinite(qobs[c])
            p = {k: float(v[2]) for k, v in params.items()}
            q = np.asarray(run_gr4j(prec[c], etp[c], 0.3, 0.3, p)[0])
            exp = np.mean((q[valid] - qobs[c][valid]) ** 2)
            assert np.isclose(losses[c, 2], exp,
                              rtol=tol(1e-9, 5e-3)), (engine, c)


def test_hbv_fused_masked_matches_subset():
    from rrmpg_jax.ops.hbvedu import run_hbvedu
    from rrmpg_jax.ops.pallas_hbv import hbv_ensemble_mse_pallas

    rng = np.random.default_rng(7)
    T, N = 250, 5
    temp = rng.uniform(-10, 20, T)
    prec = rng.uniform(0, 15, T)
    month = rng.integers(0, 12, T)
    pe_m = rng.uniform(1, 4, 12)
    t_m = rng.uniform(-5, 15, 12)
    qobs = rng.uniform(0, 5, T)
    qobs[rng.choice(T, 30, replace=False)] = np.nan
    params = {'T_t': jnp.asarray(rng.uniform(-1.5, 2.5, N)),
              'DD': jnp.asarray(rng.uniform(0.5, 5, N)),
              'FC': jnp.asarray(rng.uniform(50, 500, N)),
              'Beta': jnp.asarray(rng.uniform(1, 6, N)),
              'C': jnp.asarray(rng.uniform(0.01, 0.07, N)),
              'PWP': jnp.asarray(rng.uniform(30, 300, N)),
              'K_0': jnp.asarray(rng.uniform(0.05, 0.5, N)),
              'K_1': jnp.asarray(rng.uniform(0.01, 0.3, N)),
              'K_2': jnp.asarray(rng.uniform(0.001, 0.1, N)),
              'K_p': jnp.asarray(rng.uniform(0.001, 0.1, N)),
              'L': jnp.asarray(rng.uniform(0, 7, N))}
    losses = hbv_ensemble_mse_pallas(
        temp, prec, month, pe_m, t_m, qobs, 0.0, 100.0, 3.0, 10.0,
        params, interpret=True, masked=True)
    valid = np.isfinite(qobs)
    i = 1
    p = {k: float(v[i]) for k, v in params.items()}
    q = np.asarray(run_hbvedu(temp, prec, month, pe_m, t_m, 0.0, 100.0,
                              3.0, 10.0, p)[0])
    exp = np.mean((q[valid] - qobs[valid]) ** 2)
    assert np.isclose(float(losses[i]), exp, rtol=tol(1e-9, 5e-3))


@pytest.mark.slow
def test_snow_fused_masked_matches_subset():
    from rrmpg_jax.ops import run_cemaneigehystgr4jice
    from rrmpg_jax.ops.pallas_snow import snowgr4j_ensemble_mse_pallas

    rng = np.random.default_rng(8)
    T, L, N = 200, 3, 4
    prec = rng.uniform(0, 20, (T, L))
    temp = rng.uniform(-10, 12, (T, L))
    frac = rng.uniform(0, 1, (T, L))
    etp = rng.uniform(0, 4, T)
    fi = rng.uniform(0, 0.5, L)
    qobs = rng.uniform(0, 5, T)
    qobs[rng.choice(T, 25, replace=False)] = np.nan
    params = {'CTG': jnp.asarray(rng.uniform(0, 1, N)),
              'Kf': jnp.asarray(rng.uniform(0, 10, N)),
              'Thacc': jnp.asarray(rng.uniform(1, 1000, N)),
              'Rsp': jnp.asarray(rng.uniform(0, 1, N)),
              'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N)),
              'DDF': jnp.asarray(rng.uniform(0, 30, N))}
    losses = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2, params,
        frac_ice=jnp.asarray(fi), hyst=True, ice=True, 
        num_uh1=3, num_uh2=7, interpret=True, masked=True)
    valid = np.isfinite(qobs)
    i = 0
    p = {k: float(v[i]) for k, v in params.items()}
    q = np.asarray(run_cemaneigehystgr4jice(
        prec, temp, etp, fi, frac, 0.0, 0.0, 0.0, 0.2, 0.2, p)[0])
    exp = np.mean((q[valid] - qobs[valid]) ** 2)
    assert np.isclose(float(losses[i]), exp, rtol=tol(1e-9, 5e-3))


@pytest.mark.slow
def test_snow_regional_masked_ragged_records():
    from rrmpg_jax.ops import run_cemaneigehystgr4j
    from rrmpg_jax.parallel.regional import regional_snow_objective

    rng = np.random.default_rng(9)
    C, T, L, N = 2, 150, 2, 4
    prec = rng.uniform(0, 20, (C, T, L))
    temp = rng.uniform(-10, 12, (C, T, L))
    frac = rng.uniform(0, 1, (C, T, L))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0, 5, (C, T))
    qobs[0, 120:] = np.nan
    qobs[1, rng.choice(T, 20, replace=False)] = np.nan
    params = {'CTG': jnp.asarray(rng.uniform(0, 1, N)),
              'Kf': jnp.asarray(rng.uniform(0, 10, N)),
              'Thacc': jnp.asarray(rng.uniform(1, 1000, N)),
              'Rsp': jnp.asarray(rng.uniform(0, 1, N)),
              'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    losses = np.asarray(regional_snow_objective(
        prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2, params,
        hyst=True, interpret=True, num_uh1=3, num_uh2=7))
    assert np.isfinite(losses).all()
    for c in range(C):
        valid = np.isfinite(qobs[c])
        p = {k: float(v[1]) for k, v in params.items()}
        q = np.asarray(run_cemaneigehystgr4j(
            prec[c], temp[c], etp[c], frac[c], 0.0, 0.0, 0.0, 0.2, 0.2,
            p)[0])
        exp = np.mean((q[valid] - qobs[c][valid]) ** 2)
        assert np.isclose(losses[c, 1], exp, rtol=tol(1e-9, 5e-3)), c


# ---------------------------------------------------------------------------
# End-to-end: fit / monte_carlo on gapped observations
# ---------------------------------------------------------------------------

def test_fit_and_monte_carlo_with_gaps():
    from rrmpg_jax.models import GR4J
    from rrmpg_jax.tools import monte_carlo

    rng = np.random.default_rng(10)
    T = 365
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    truth = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.8}
    model = GR4J(params=truth)
    qobs = np.array(model.simulate(prec, etp))[:, 0].copy()
    qobs[rng.choice(T, 60, replace=False)] = np.nan

    mc = monte_carlo(model, num=64, qobs=qobs, prec=prec, etp=etp,
                     metrics=('mse', 'nse'))
    assert np.isfinite(mc['mse']).all()
    assert np.isfinite(mc['nse']).all()

    for engine in ("xla", "pallas"):
        res = model.fit(qobs, prec, etp, seed=0, maxiter=8,
                        engine=engine, interpret=True)
        assert np.isfinite(res.fun), engine
        # The truth parameters give zero loss on the valid subset, so
        # even a short calibration must land well below the obs variance.
        assert res.fun < np.nanvar(qobs), engine


def test_trajectory_free_mc_with_gaps():
    """monte_carlo(return_qsim=False, engine='pallas') on gapped obs:
    the fused sufficient-statistics path selects the masked kernel and
    matches the (NaN-aware) trajectory metrics."""
    from rrmpg_jax.models import GR4J
    from rrmpg_jax.tools import monte_carlo

    rng = np.random.default_rng(21)
    T = 250
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    qobs = rng.uniform(0.5, 5, T)
    qobs[rng.choice(T, 40, replace=False)] = np.nan
    model = GR4J()
    metrics = ('mse', 'nse', 'kge')
    np.random.seed(7)
    r_traj = monte_carlo(model, 16, qobs=qobs, prec=prec, etp=etp,
                         metrics=metrics)
    np.random.seed(7)
    r_fast = monte_carlo(model, 16, qobs=qobs, prec=prec, etp=etp,
                         metrics=metrics, return_qsim=False,
                         engine='pallas', interpret=True)
    for m in metrics:
        ok = np.isfinite(r_traj[m])
        assert ok.any()
        np.testing.assert_allclose(r_fast[m][ok], r_traj[m][ok],
                                   rtol=tol(1e-8, 2e-3),
                                   atol=tol(1e-10, 1e-3), err_msg=m)


def test_warm_fused_fit_with_gaps():
    """fit(initial_state=, engine='pallas') with gapped observations:
    the warm masked kernel agrees with the warm XLA objective."""
    from rrmpg_jax.models import GR4J

    rng = np.random.default_rng(22)
    T = 300
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    truth = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.8}
    model = GR4J(params=truth)
    _, state = model.simulate(prec[:200], etp[:200], s_init=0.5,
                              r_init=0.5, return_final_state=True)
    qobs = np.array(model.simulate(prec[200:], etp[200:],
                                   initial_state=state))[:, 0].copy()
    qobs[rng.choice(len(qobs), 20, replace=False)] = np.nan

    res_p = model.fit(qobs, prec[200:], etp[200:], initial_state=state,
                      engine="pallas", interpret=True, seed=0,
                      maxiter=10)
    res_x = model.fit(qobs, prec[200:], etp[200:], initial_state=state,
                      engine="xla", seed=0, maxiter=10)
    assert np.isfinite(res_p.fun)
    np.testing.assert_allclose(res_p.fun, res_x.fun,
                               rtol=tol(1e-6, 5e-5))
    np.testing.assert_allclose(res_p.x, res_x.x, rtol=tol(1e-5, 1e-3))


def test_load_basins_to_regional_objective_end_to_end(tmp_path):
    """The full multi-basin chain: CAMELS-format files with -999 gaps
    -> load_basins(join='outer') -> masked regional GR4J sweep with
    finite, hand-checkable per-catchment losses."""
    from rrmpg_jax.data import CAMELSLoader
    from rrmpg_jax.ops.gr4j import run_gr4j
    from rrmpg_jax.parallel.regional import regional_gr4j_objective

    _write_camels_basin(tmp_path, "02002000", T=800)
    _write_camels_basin(tmp_path, "02002001", T=800,
                        q_sentinel_rows=tuple(range(350, 420)))
    loader = CAMELSLoader(data_dir=tmp_path)
    index, arrays = loader.load_basins(join="outer")
    prec = arrays["prcp(mm/day)"]
    etp = arrays["PET"]
    qobs = arrays["QObs(mm/d)"]
    assert np.isnan(qobs).any() and np.isfinite(prec).all()

    rng = np.random.default_rng(3)
    N = 5
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    losses = np.asarray(regional_gr4j_objective(
        prec, etp, qobs, 0.3, 0.3, params, engine="xla"))
    assert losses.shape == (2, N)
    assert np.isfinite(losses).all()
    # Hand-check the gapped basin against the valid-subset MSE.
    c = 1
    valid = np.isfinite(qobs[c])
    assert valid.sum() < qobs.shape[1]
    p = {k: float(v[3]) for k, v in params.items()}
    q = np.asarray(run_gr4j(prec[c], etp[c], 0.3, 0.3, p)[0])
    exp = np.mean((q[valid] - qobs[c][valid]) ** 2)
    assert np.isclose(losses[c, 3], exp, rtol=tol(1e-9, 5e-3))
