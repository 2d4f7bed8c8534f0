"""Pallas fused GR4J kernel parity tests (interpreter mode, CPU x64).

The fused kernels must reproduce the scan/conv XLA path (which itself is
golden-validated against the authors' Excel implementation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.ops import fused, run_gr4j
from rrmpg_jax.ops.pallas_gr4j import (
    BLOCK,
    gr4j_ensemble_mse_pallas,
    gr4j_simulate_pallas,
)

from lane import tol


def _inputs(T, N, seed=0, x4_max=9.9):
    rng = np.random.default_rng(seed)
    prec = jnp.asarray(rng.uniform(0, 15, T))
    etp = jnp.asarray(rng.uniform(0, 4, T))
    qobs = jnp.asarray(rng.uniform(0, 5, T))
    params = {k: jnp.asarray(v) for k, v in {
        'x1': rng.uniform(100, 1200, N), 'x2': rng.uniform(-5, 3, N),
        'x3': rng.uniform(20, 300, N),
        'x4': rng.uniform(1.1, x4_max, N)}.items()}
    return prec, etp, qobs, params


def _xla_qsim(prec, etp, params):
    return jax.vmap(lambda p: run_gr4j(prec, etp, 0.4, 0.3, p)[0])(params)


@pytest.mark.slow
def test_traj_kernel_matches_xla():
    prec, etp, _, params = _inputs(200, BLOCK)
    qsim_p = gr4j_simulate_pallas(prec, etp, 0.4, 0.3, params, 
                                  interpret=True)
    qsim_x = _xla_qsim(prec, etp, params)
    assert np.allclose(np.asarray(qsim_p), np.asarray(qsim_x),
                       rtol=tol(1e-5, 5e-3), atol=tol(1e-8, 1e-3))


@pytest.mark.slow
def test_traj_kernel_t_padding():
    # T=150 is no power of two: the time loop has no tile to pad to.
    prec, etp, _, params = _inputs(150, BLOCK, seed=3)
    qsim_p = gr4j_simulate_pallas(prec, etp, 0.1, 0.6, params, 
                                  interpret=True)
    qsim_x = jax.vmap(
        lambda p: run_gr4j(prec, etp, 0.1, 0.6, p)[0])(params)
    assert qsim_p.shape == (BLOCK, 150)
    assert np.allclose(np.asarray(qsim_p), np.asarray(qsim_x),
                       rtol=tol(1e-5, 5e-3), atol=tol(1e-8, 1e-3))


@pytest.mark.slow
def test_mse_kernel_matches_xla():
    prec, etp, qobs, params = _inputs(200, BLOCK, seed=1)
    mse_p = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.4, 0.3, params,
                                     interpret=True)
    qsim_x = _xla_qsim(prec, etp, params)
    mse_x = jnp.mean((qsim_x - qobs[None, :]) ** 2, axis=1)
    assert np.allclose(np.asarray(mse_p), np.asarray(mse_x))


def test_mse_kernel_member_padding():
    # N not a multiple of the member block -> member padding path.
    prec, etp, qobs, params = _inputs(130, 100, seed=2)
    mse_p = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.2, 0.2, params,
                                     interpret=True)
    assert mse_p.shape == (100,)
    qsim_x = jax.vmap(
        lambda p: run_gr4j(prec, etp, 0.2, 0.2, p)[0])(params)
    mse_x = jnp.mean((qsim_x - qobs[None, :]) ** 2, axis=1)
    assert np.allclose(np.asarray(mse_p), np.asarray(mse_x))


@pytest.mark.slow
def test_short_uh_registers():
    # 3/7-tap registers are exact for plain-GR4J bounds (x4 <= 2.9).
    prec, etp, qobs, params = _inputs(150, BLOCK, seed=4, x4_max=2.9)
    mse_p = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.4, 0.3, params,
                                     num_uh1=3, num_uh2=7,
                                     interpret=True)
    qsim_x = _xla_qsim(prec, etp, params)
    mse_x = jnp.mean((qsim_x - qobs[None, :]) ** 2, axis=1)
    assert np.allclose(np.asarray(mse_p), np.asarray(mse_x))


def test_gr4j_class_pallas_engine():
    from rrmpg_jax.models import GR4J

    model = GR4J()
    params = model.get_random_params(num=10)
    prec = np.random.default_rng(5).uniform(0, 10, 120)
    etp = np.random.default_rng(6).uniform(0, 3, 120)
    q_pallas = model.simulate(prec, etp, params=params, engine="pallas",
                              interpret=True)
    q_xla = model.simulate(prec, etp, params=params)
    assert np.allclose(q_pallas, q_xla, rtol=tol(1e-4, 3e-3),
                       atol=tol(1e-6, 1e-4))


def test_gr4j_class_pallas_fit_interpret():
    from rrmpg_jax.models import GR4J

    rng = np.random.default_rng(9)
    prec = rng.uniform(0, 12, 150)
    etp = rng.uniform(0, 4, 150)
    truth = GR4J(params={'x1': 300., 'x2': 1.0, 'x3': 80., 'x4': 2.0})
    qobs = truth.simulate(prec, etp).flatten()
    res = GR4J().fit(qobs, prec, etp, seed=0, maxiter=2, engine="pallas",
                     interpret=True)
    assert np.isfinite(res.fun)


def test_pallas_engine_rejects_storage():
    from rrmpg_jax.models import GR4J

    with pytest.raises(ValueError):
        GR4J().simulate(np.ones(10), np.ones(10), return_storage=True,
                        engine="pallas")


def test_gr4j_stats_variant_matches_trajectory():
    """stats=True returns the exact time-mean sufficient statistics of
    the fused trajectory, and the derived 1-KGE matches the XLA
    objective."""
    import jax.numpy as jnp

    from rrmpg_jax.ops.pallas_gr4j import (
        gr4j_ensemble_mse_pallas,
        gr4j_simulate_pallas,
    )
    from rrmpg_jax.ops.pallas_snow import losses_from_stats
    from rrmpg_jax.utils.metrics import kge as jkge

    rng = np.random.default_rng(0)
    T, N = 200, 16
    prec = jnp.asarray(rng.uniform(0, 15, T))
    etp = jnp.asarray(rng.uniform(0, 4, T))
    qobs = jnp.asarray(rng.uniform(0, 5, T))
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}

    stats = np.asarray(gr4j_ensemble_mse_pallas(
        prec, etp, qobs, 0.3, 0.3, params, num_uh1=3, num_uh2=7,
        interpret=True, stats=True))
    assert stats.shape == (4, N)

    qsim = np.asarray(gr4j_simulate_pallas(
        prec, etp, 0.3, 0.3, params, num_uh1=3, num_uh2=7,
        interpret=True))  # (N, T)
    qo = np.asarray(qobs)
    np.testing.assert_allclose(stats[0],
                               np.mean((qsim - qo) ** 2, axis=1),
                               rtol=1e-6)
    np.testing.assert_allclose(stats[1], qsim.mean(axis=1), rtol=1e-6)
    np.testing.assert_allclose(stats[2], (qsim ** 2).mean(axis=1),
                               rtol=1e-6)
    np.testing.assert_allclose(stats[3], (qsim * qo).mean(axis=1),
                               rtol=1e-6)

    got = 1.0 - np.asarray(
        losses_from_stats(jnp.asarray(stats), qobs)['kge'])
    want = 1.0 - np.asarray(jkge(qo[None, :], qsim, axis=1))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_gr4j_class_pallas_fit_kge(gr4j_synthetic=None):
    """fit(engine='pallas', loss_metric='kge') runs through the class
    API in interpret mode and reaches a low 1-KGE."""
    from rrmpg_jax.models import GR4J

    rng = np.random.default_rng(3)
    T = 150
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    truth = {'x1': 350.0, 'x2': 1.2, 'x3': 80.0, 'x4': 1.8}
    qobs = GR4J(params=truth).simulate(prec, etp)[:, 0]
    res = GR4J().fit(qobs, prec, etp, loss_metric='kge', seed=0,
                     engine='pallas', interpret=True, maxiter=15)
    assert np.isfinite(res.fun)
    assert res.fun < 0.5  # 1 - KGE well below the random baseline


@pytest.mark.parametrize("n,block,want", [
    (1, None, fused.MIN_BLOCK), (100, None, min(fused.BLOCK, 128)),
    (131072, None, fused.BLOCK), (300, 64, 64), (5, 256, 256)])
def test_block_size_choice(n, block, want):
    assert fused.block_size(n, block) == want


@pytest.mark.parametrize("block", [0, -4, 3, 96])
def test_block_size_rejects_non_power_of_two(block):
    with pytest.raises(ValueError, match="power of two"):
        fused.block_size(100, block)


def test_member_padding_is_invisible():
    """100 members in blocks of 32 (28 padded lanes) or one block of 128:
    identical losses, statistics and trajectories."""
    prec, etp, qobs, params = _inputs(60, 100, seed=8)
    kw = dict(interpret=True, num_uh1=10, num_uh2=21)
    for stats in (False, True):
        a = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.3, 0.3, params,
                                     stats=stats, block=32, **kw)
        b = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.3, 0.3, params,
                                     stats=stats, block=128, **kw)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    q = gr4j_simulate_pallas(prec, etp, 0.3, 0.3, params, block=32, **kw)
    assert q.shape == (100, 60)
