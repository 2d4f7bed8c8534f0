"""Tests for Monte-Carlo and the device-resident calibration tools."""

import numpy as np
import pytest

from rrmpg_jax.models import ABCModel, GR4J
from rrmpg_jax.tools import differential_evolution, monte_carlo, random_search


def test_monte_carlo_shapes():
    model = ABCModel()
    num = 32
    prec = np.random.uniform(0, 10, 100)
    qobs = np.random.uniform(0, 2, 100)
    result = monte_carlo(model, num, qobs=qobs, prec=prec)
    assert result['qsim'].shape == (100, num)
    assert result['params'].size == num
    assert result['mse'].shape == (num,)
    # mse entries must match a direct recomputation
    i = 7
    assert np.isclose(result['mse'][i],
                      np.mean((result['qsim'][:, i] - qobs) ** 2))


def test_monte_carlo_without_qobs():
    result = monte_carlo(ABCModel(), 4, prec=np.random.uniform(0, 10, 50))
    assert set(result.keys()) == {'params', 'qsim'}


def test_monte_carlo_rejects_non_model():
    with pytest.raises(TypeError):
        monte_carlo(object(), 10)


def test_monte_carlo_rejects_bad_num():
    with pytest.raises(TypeError):
        monte_carlo(ABCModel(), 0)


def test_de_minimizes_quadratic():
    import jax.numpy as jnp

    target = jnp.asarray([0.3, -1.2, 2.5])

    def objective(x):
        return jnp.sum((x - target) ** 2)

    res = differential_evolution(objective, [(-5, 5)] * 3, seed=0)
    assert res.success
    assert np.allclose(res.x, np.asarray(target), atol=1e-4)
    assert res.fun < 1e-8
    assert res.nfev == 45 * (res.nit + 1)


@pytest.mark.slow
def test_de_recovers_abc_params():
    from rrmpg_jax.utils.metrics import mse as jmse
    from rrmpg_jax.ops import run_abcmodel_pscan
    import jax.numpy as jnp

    rng = np.random.default_rng(42)
    prec = jnp.asarray(rng.uniform(0, 20, 500))
    true = {'a': 0.35, 'b': 0.2, 'c': 0.2}
    qobs, _ = run_abcmodel_pscan(prec, 0.0, true)

    def objective(x):
        qsim, _ = run_abcmodel_pscan(prec, 0.0,
                                     {'a': x[0], 'b': x[1], 'c': x[2]})
        return jmse(qobs, qsim)

    res = differential_evolution(objective, [(0, 1)] * 3, seed=1)
    assert res.fun < 1e-8
    assert np.allclose(res.x, [0.35, 0.2, 0.2], atol=1e-3)


def test_model_fit_api():
    rng = np.random.default_rng(3)
    prec = rng.uniform(0, 20, 300)
    true = ABCModel(params={'a': 0.3, 'b': 0.3, 'c': 0.1})
    qobs = true.simulate(prec).flatten()
    res = ABCModel().fit(qobs, prec, seed=0, maxiter=200)
    assert res.fun < 1e-6


def test_random_search():
    import jax
    import jax.numpy as jnp

    def objective(x):
        return jnp.sum(x ** 2)

    def sample_fn(key, n):
        return jax.random.uniform(key, (n, 2), minval=-3, maxval=3)

    res = random_search(objective, sample_fn, 512, seed=0)
    assert res.nfev == 512
    assert res.fun < 0.1


@pytest.mark.slow
def test_gr4j_fit_smoke():
    rng = np.random.default_rng(5)
    prec = rng.uniform(0, 15, 200)
    etp = rng.uniform(0, 4, 200)
    true_p = {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}
    qobs = GR4J(params=true_p).simulate(prec, etp).flatten()
    res = GR4J().fit(qobs, prec, etp, seed=0, maxiter=150)
    assert res.fun < 1e-4


def test_monte_carlo_multiple_metrics():
    model = ABCModel()
    prec = np.random.uniform(0, 10, 150)
    qobs = np.random.uniform(0.5, 2, 150)
    result = monte_carlo(model, 16, qobs=qobs, prec=prec,
                         metrics=('mse', 'nse', 'kge'))
    for name in ('mse', 'nse', 'kge'):
        assert result[name].shape == (16,)
    from rrmpg_jax.utils import calc_kge, calc_nse
    assert np.isclose(result['nse'][3], calc_nse(qobs, result['qsim'][:, 3]))
    assert np.isclose(result['kge'][3], calc_kge(qobs, result['qsim'][:, 3]))


def test_monte_carlo_signature_metrics():
    model = ABCModel()
    prec = np.random.uniform(0, 10, 200)
    qobs = np.random.uniform(0.5, 2, 200)
    result = monte_carlo(model, 8, qobs=qobs, prec=prec,
                         metrics=('fhv', 'flv', 'fms'))
    from rrmpg_jax.utils.signatures import fdc_fhv
    for name in ('fhv', 'flv', 'fms'):
        assert result[name].shape == (8,)
        assert np.isfinite(result[name]).all()
    assert np.isclose(result['fhv'][2],
                      float(fdc_fhv(qobs, result['qsim'][:, 2], axis=0)))


def test_monte_carlo_unknown_metric():
    with pytest.raises(ValueError):
        monte_carlo(ABCModel(), 4, qobs=np.ones(10),
                    prec=np.random.uniform(0, 1, 10), metrics=('nash',))


def test_gradient_descent_quadratic():
    import jax.numpy as jnp
    from rrmpg_jax.tools import gradient_descent

    target = jnp.asarray([0.3, -1.2])

    def objective(x):
        return jnp.sum((x - target) ** 2)

    res = gradient_descent(objective, [(-5, 5)] * 2, seed=0, steps=800,
                           learning_rate=0.02)
    assert res.success
    assert np.allclose(res.x, np.asarray(target), atol=1e-2)


@pytest.mark.slow
def test_gradient_descent_refines_de_result():
    import jax.numpy as jnp
    from rrmpg_jax.ops import run_gr4j
    from rrmpg_jax.tools import gradient_descent
    from rrmpg_jax.utils.metrics import mse as jmse

    rng = np.random.default_rng(6)
    prec = jnp.asarray(rng.uniform(0, 15, 300))
    etp = jnp.asarray(rng.uniform(0, 4, 300))
    true = {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}
    qobs = run_gr4j(prec, etp, 0.3, 0.3, true)[0]

    def objective(x):
        params = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
        return jmse(qobs, run_gr4j(prec, etp, 0.3, 0.3, params)[0])

    bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]
    coarse = differential_evolution(objective, bounds, seed=0, maxiter=15,
                                    tol=0.0)
    polished = gradient_descent(objective, bounds, x0=coarse.x, steps=300,
                                learning_rate=0.01)
    assert polished.fun <= coarse.fun


def test_random_search_batched_objective():
    import jax
    import jax.numpy as jnp
    from rrmpg_jax.tools import random_search

    def batch_objective(X):          # (n, 2) -> (n,)
        return jnp.sum(X ** 2, axis=1)

    def sample_fn(key, n):
        return jax.random.uniform(key, (n, 2), minval=-3, maxval=3)

    res = random_search(batch_objective, sample_fn, 1024, seed=0,
                        batch_size=256, batched=True)
    assert res.nfev == 1024
    assert res.fun < 0.05


def test_de_polish_never_worsens():
    import jax.numpy as jnp
    from rrmpg_jax.tools.calibration import differential_evolution

    target = jnp.asarray([0.4, -0.7])
    bounds = [(-2, 2), (-2, 2)]

    def obj(x):
        return jnp.sum((x - target) ** 2)

    plain = differential_evolution(obj, bounds, seed=4, maxiter=5)
    polished = differential_evolution(obj, bounds, seed=4, maxiter=5,
                                      polish=True)
    assert polished.fun <= plain.fun
    assert polished.nfev > plain.nfev           # polish evals are counted
    assert np.allclose(polished.x, np.asarray(target), atol=1e-3)


@pytest.mark.slow
def test_gr4j_fit_polish_improves_short_run():
    from rrmpg_jax.models import GR4J

    rng = np.random.default_rng(12)
    prec = rng.uniform(0, 12, 300)
    etp = rng.uniform(0, 4, 300)
    truth = GR4J(params={'x1': 280., 'x2': 0.5, 'x3': 80., 'x4': 2.2})
    qobs = truth.simulate(prec, etp).flatten()
    model = GR4J()
    plain = model.fit(qobs, prec, etp, seed=1, maxiter=6)
    polished = model.fit(qobs, prec, etp, seed=1, maxiter=6, polish=True)
    assert polished.fun <= plain.fun


def test_nonfinite_members_diagnostic():
    """Members with NaN losses are quarantined by the DE and retrievable
    from the result for debugging."""
    import jax.numpy as jnp
    from rrmpg_jax.tools.calibration import differential_evolution

    def obj(x):
        # NaN wherever x0 < 0 -- roughly half the search box.
        val = jnp.sum((x - 0.5) ** 2)
        return jnp.where(x[0] < 0, jnp.nan, val)

    res = differential_evolution(obj, [(-1, 1), (-1, 1)], seed=2,
                                 maxiter=3, tol=0.0)
    members, energies = res.nonfinite_members()
    assert members.shape[1] == 2
    assert len(members) == len(energies)
    assert np.isfinite(res.fun)          # best is never a NaN member
    assert res.x[0] >= 0
    if len(members):                     # flagged in the message too
        assert "non-finite" in res.message
        assert np.all(members[:, 0] < 0)
        assert not np.isfinite(energies).any()


def test_de_never_selects_infinite_member():
    """Non-finite is more than NaN: +-inf members must also be quarantined
    from best-member selection and incumbent shielding."""
    import jax.numpy as jnp
    from rrmpg_jax.tools.calibration import differential_evolution

    def obj(x):
        val = jnp.sum((x - 0.5) ** 2)
        # -inf trap in half the box: must never win despite "minimizing".
        return jnp.where(x[0] < 0, -jnp.inf, val)

    res = differential_evolution(obj, [(-1, 1), (-1, 1)], seed=3,
                                 maxiter=8, tol=0.0)
    assert np.isfinite(res.fun)
    assert res.x[0] >= 0


def test_monte_carlo_batch_size_matches_unchunked():
    """Chunked (memory-bounded) Monte-Carlo equals the single-program run
    member for member, including the metrics and a remainder chunk."""
    rng = np.random.default_rng(8)
    prec = rng.uniform(0, 12, 200)
    etp = rng.uniform(0, 4, 200)
    qobs = rng.uniform(0, 5, 200)
    model = GR4J()
    np.random.seed(77)
    full = monte_carlo(model, 10, qobs=qobs, prec=prec, etp=etp,
                       metrics=('mse', 'nse'))
    np.random.seed(77)
    chunked = monte_carlo(model, 10, qobs=qobs, prec=prec, etp=etp,
                          metrics=('mse', 'nse'), batch_size=4)
    assert np.array_equal(
        np.asarray(full['params'].tolist()),
        np.asarray(chunked['params'].tolist()))
    assert np.allclose(full['qsim'], chunked['qsim'], rtol=1e-12)
    assert np.allclose(full['mse'], chunked['mse'], rtol=1e-12)
    assert np.allclose(full['nse'], chunked['nse'], rtol=1e-12)

    with pytest.raises(TypeError, match="batch_size"):
        monte_carlo(model, 10, prec=prec, etp=etp, batch_size=0)
