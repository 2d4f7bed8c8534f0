"""Fit-path coverage across the remaining model classes + engine guards."""

import numpy as np
import pytest

from rrmpg_jax.models import Cemaneige, CemaneigeGR4J, GR4J
from rrmpg_jax.parallel import default_mesh
from rrmpg_jax.tools import monte_carlo

from lane import tol


def _met(T=200, seed=4):
    rng = np.random.default_rng(seed)
    prec = rng.uniform(0, 12, T)
    mean_t = rng.uniform(-8, 12, T)
    return prec, mean_t, mean_t - 2, mean_t + 2, rng.uniform(0, 3, T)


def test_cemaneige_fit_smoke():
    prec, mean_t, min_t, max_t, etp = _met()
    obs = np.random.default_rng(5).uniform(0, 4, 200)
    res = Cemaneige().fit(obs, prec, mean_t, min_t, max_t,
                          met_station_height=500,
                          altitudes=[400, 600, 800], seed=0, maxiter=3,
                          tol=0.0)
    assert res.nit == 3 and np.isfinite(res.fun)


@pytest.mark.slow
def test_cemaneigegr4j_fit_recovers_params():
    prec, mean_t, min_t, max_t, etp = _met(T=400)
    true = {'CTG': 0.25, 'Kf': 3.74, 'x1': 300.0, 'x2': 1.0, 'x3': 90.0,
            'x4': 2.0}
    model = CemaneigeGR4J(params=true)
    qobs = model.simulate(prec, mean_t, min_t, max_t, etp,
                          met_station_height=500).flatten()
    res = CemaneigeGR4J().fit(qobs, prec, mean_t, min_t, max_t, etp,
                              met_station_height=500, seed=0, maxiter=150)
    assert res.fun < 1e-3


def test_invalid_engine_raises():
    prec, mean_t, min_t, max_t, etp = _met()
    obs = np.zeros(200)
    with pytest.raises(ValueError):
        GR4J().simulate(prec, etp, engine="cuda")
    with pytest.raises(ValueError):
        GR4J().fit(obs, prec, etp, engine="cuda")
    with pytest.raises(ValueError):
        CemaneigeGR4J().fit(obs, prec, mean_t, min_t, max_t, etp,
                            met_station_height=500, engine="cuda")


def test_monte_carlo_with_mesh():
    model = GR4J()
    prec = np.random.uniform(0, 10, 150)
    etp = np.random.uniform(0, 3, 150)
    qobs = np.random.uniform(0, 2, 150)
    result = monte_carlo(model, 24, qobs=qobs, mesh=default_mesh(),
                         prec=prec, etp=etp)
    assert result['qsim'].shape == (150, 24)
    assert np.isfinite(result['mse']).all()


def test_fit_loss_metric_kge():
    """Every plain fit accepts loss_metric: KGE-calibrating GR4J on a
    synthetic truth drives 1-KGE to ~0, and the optimum differs from
    the MSE fit's objective value scale (sanity that the loss actually
    switched)."""
    from rrmpg_jax.models import GR4J
    from rrmpg_jax.utils import calc_kge

    rng = np.random.default_rng(0)
    T = 300
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    truth = {'x1': 350.0, 'x2': 1.2, 'x3': 80.0, 'x4': 1.8}
    qobs = GR4J(params=truth).simulate(prec, etp)[:, 0]

    res = GR4J().fit(qobs, prec, etp, loss_metric='kge', seed=0,
                     maxiter=60)
    assert res.fun < 0.02  # 1 - KGE near zero
    m = GR4J(params=dict(zip(GR4J._param_list, res.x)))
    qsim = m.simulate(prec, etp)[:, 0]
    assert calc_kge(qobs, qsim) > 0.98

    # nse/rmse accepted; unknown rejected; the fused engine supports
    # every metric via the stats kernel.
    r2 = GR4J().fit(qobs, prec, etp, loss_metric='nse', seed=0,
                    maxiter=5)
    assert np.isfinite(r2.fun)
    with pytest.raises(ValueError, match="loss_metric"):
        GR4J().fit(qobs, prec, etp, loss_metric='nash')
    r3 = GR4J().fit(qobs, prec, etp, loss_metric='kge', seed=0,
                    engine='pallas', interpret=True, maxiter=3)
    assert np.isfinite(r3.fun)


def test_fit_loss_metric_all_classes_smoke():
    """loss_metric='kge' reaches the optimizer on every non-hyst class."""
    from rrmpg_jax.models import ABCModel, Cemaneige, CemaneigeGR4J, HBVEdu

    rng = np.random.default_rng(1)
    T = 120
    prec = rng.uniform(0, 10, T)

    r = ABCModel().fit(rng.uniform(0.5, 2, T), prec, loss_metric='kge',
                       seed=0, maxiter=3)
    assert np.isfinite(r.fun)

    temp = rng.uniform(-5, 15, T)
    month = np.repeat(np.arange(1, 13), 10)
    r = HBVEdu().fit(rng.uniform(0.5, 2, T), temp, prec, month,
                             np.tile(rng.uniform(1, 3, 12), 1),
                             rng.uniform(-2, 15, 12),
                             loss_metric='kge', seed=0, maxiter=3)
    assert np.isfinite(r.fun)

    mean_t = rng.uniform(-10, 10, T)
    kw = dict(met_station_height=500,
              altitudes=[400, 600, 800, 1000, 1200])
    r = Cemaneige().fit(rng.uniform(0, 5, T), prec, mean_t, mean_t - 3,
                        mean_t + 3, loss_metric='kge', seed=0,
                        maxiter=3, **kw)
    assert np.isfinite(r.fun)

    r = CemaneigeGR4J().fit(rng.uniform(0, 5, T), prec, mean_t,
                            mean_t - 3, mean_t + 3,
                            rng.uniform(0, 4, T), loss_metric='kge',
                            seed=0, maxiter=3, **kw)
    assert np.isfinite(r.fun)


def test_fused_snow_fit_kge_matches_xla():
    """The fused snow fit's 1-KGE objective (stats variant, interpret)
    equals the XLA objective on identical candidates."""
    import jax.numpy as jnp

    from rrmpg_jax.models import CemaneigeGR4J
    from rrmpg_jax.ops.compositions import run_cemaneigegr4j
    from rrmpg_jax.utils.metrics import kge as jkge

    rng = np.random.default_rng(2)
    T = 120
    mean_t = rng.uniform(-8, 10, T)
    m = CemaneigeGR4J()
    (prec, mt, fsp, etp, *_inits) = m._prepare(
        rng.gamma(0.8, 6.0, T), mean_t, mean_t - 3, mean_t + 3,
        rng.uniform(0.5, 3, T), 500,
        [400, 600, 800, 1000, 1200], 0, 0, 0, 0)
    qobs = rng.uniform(0, 5, T)

    fused = m._pallas_batch_objective(
        'kge', prec, mt, etp, fsp, qobs, 0.0, 0.0, 0.0, 0.0,
        interpret=True)
    X = np.column_stack([rng.uniform(*m._default_bounds[p], 6)
                         for p in m._param_list])
    got = np.asarray(fused(jnp.asarray(X)))

    args = tuple(jnp.asarray(a) for a in (prec, mt, etp, fsp))
    qobs_j = jnp.asarray(qobs)
    for j in range(6):
        params = {n: X[j, i] for i, n in enumerate(m._param_list)}
        qsim = run_cemaneigegr4j(*args, 0.0, 0.0, 0.0, 0.0, params)[0]
        want = 1.0 - float(jkge(qobs_j, qsim))
        np.testing.assert_allclose(got[j], want,
                                   rtol=tol(1e-7, 5e-3))
