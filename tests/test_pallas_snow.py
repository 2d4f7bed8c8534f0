"""Parity tests for the fused coupled-model (snow+GR4J) Pallas kernel.

All four composition variants (plain/hysteresis x ice/no-ice) and the
sufficient-statistics mode must reproduce the XLA compositions (which are
golden-validated against the authors' Excel data).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lane import tol

pytestmark = pytest.mark.slow

from rrmpg_jax.ops import (
    run_cemaneigegr4j,
    run_cemaneigegr4jice,
    run_cemaneigehystgr4j,
    run_cemaneigehystgr4jice,
)
from rrmpg_jax.ops.pallas_snow import (
    losses_from_stats,
    snowgr4j_ensemble_mse_pallas,
)
from rrmpg_jax.utils.metrics import kge as jkge
from rrmpg_jax.utils.metrics import nse as jnse


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    T, L, N = 150, 5, 1024
    prec = jnp.asarray(rng.uniform(0, 15, (T, L)))
    temp = jnp.asarray(rng.uniform(-12, 18, (T, L)))
    frac = jnp.asarray(np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1))
    etp = jnp.asarray(rng.uniform(0, 4, T))
    qobs = jnp.asarray(rng.uniform(1, 5, T))
    frac_ice = jnp.asarray(rng.uniform(0, 0.7, L))
    params = {k: jnp.asarray(v) for k, v in {
        'CTG': rng.uniform(0, 1, N), 'Kf': rng.uniform(0, 10, N),
        'Thacc': rng.uniform(1, 100, N), 'Rsp': rng.uniform(0, 1, N),
        'x1': rng.uniform(10, 1200, N), 'x2': rng.uniform(-5, 3, N),
        'x3': rng.uniform(20, 5000, N), 'x4': rng.uniform(1.1, 9.9, N),
        'DDF': rng.uniform(0, 30, N)}.items()}
    return prec, temp, frac, etp, qobs, frac_ice, params


def _mse(qsim_batch, qobs):
    return jnp.mean((qsim_batch - qobs[None, :]) ** 2, axis=1)


def test_plain_variant(data):
    prec, temp, frac, etp, qobs, _, params = data
    m_p = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 2.0, -1.0, 0.4, 0.3, params,
        interpret=True)
    q_x = jax.vmap(lambda p: run_cemaneigegr4j(
        prec, temp, etp, frac, 2.0, -1.0, 0.4, 0.3, p)[0])(params)
    assert np.allclose(np.asarray(m_p), np.asarray(_mse(q_x, qobs)),
                       rtol=tol(1e-5, 1e-3), atol=tol(1e-8, 1e-4))


def test_hyst_variant(data):
    prec, temp, frac, etp, qobs, _, params = data
    m_p = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 2.0, -1.0, 0.4, 0.3, params,
        hyst=True, interpret=True)
    q_x = jax.vmap(lambda p: run_cemaneigehystgr4j(
        prec, temp, etp, frac, 2.0, -1.0, 0.0, 0.4, 0.3, p)[0])(params)
    assert np.allclose(np.asarray(m_p), np.asarray(_mse(q_x, qobs)),
                       rtol=tol(1e-5, 1e-3), atol=tol(1e-8, 1e-4))


def test_ice_variant(data):
    prec, temp, frac, etp, qobs, frac_ice, params = data
    m_p = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 2.0, -1.0, 0.4, 0.3, params,
        frac_ice=frac_ice, ice=True, interpret=True)
    q_x = jax.vmap(lambda p: run_cemaneigegr4jice(
        prec, temp, etp, frac_ice, frac, 2.0, -1.0, 0.4, 0.3,
        p)[0])(params)
    assert np.allclose(np.asarray(m_p), np.asarray(_mse(q_x, qobs)),
                       rtol=tol(1e-5, 1e-3), atol=tol(1e-8, 1e-4))


def test_hyst_ice_variant_with_stats(data):
    prec, temp, frac, etp, qobs, frac_ice, params = data
    stats = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 2.0, -1.0, 0.4, 0.3, params,
        frac_ice=frac_ice, hyst=True, ice=True, stats=True, 
        interpret=True)
    losses = losses_from_stats(stats, qobs)
    q_x = jax.vmap(lambda p: run_cemaneigehystgr4jice(
        prec, temp, etp, frac_ice, frac, 2.0, -1.0, 0.0, 0.4, 0.3,
        p)[0])(params)
    assert np.allclose(np.asarray(losses['mse']),
                       np.asarray(_mse(q_x, qobs)),
                       rtol=tol(1e-5, 1e-3), atol=tol(1e-8, 1e-4))
    assert np.allclose(np.asarray(losses['kge']),
                       np.asarray(jkge(qobs[None, :], q_x, axis=-1)),
                       rtol=tol(1e-5, 3e-3), atol=tol(1e-8, 1e-4))
    assert np.allclose(np.asarray(losses['nse']),
                       np.asarray(jnse(qobs[None, :], q_x, axis=-1)),
                       rtol=tol(1e-5, 3e-3), atol=tol(1e-8, 1e-4))


def test_traj_variants_match_xla(data):
    from rrmpg_jax.ops.pallas_snow import snowgr4j_simulate_pallas

    prec, temp, frac, etp, qobs, frac_ice, params = data
    q_p = snowgr4j_simulate_pallas(prec, temp, etp, frac, 2.0, -1.0, 0.4,
                                   0.3, params, frac_ice=frac_ice,
                                   hyst=True, ice=True, 
                                   interpret=True)
    q_x = jax.vmap(lambda p: run_cemaneigehystgr4jice(
        prec, temp, etp, frac_ice, frac, 2.0, -1.0, 0.0, 0.4, 0.3,
        p)[0])(params)
    assert np.allclose(np.asarray(q_p), np.asarray(q_x),
                       rtol=tol(1e-5, 1e-3), atol=tol(1e-8, 1e-3))
