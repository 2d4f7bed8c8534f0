"""Parity tests for the fused HBV-Edu Pallas kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.ops import run_hbvedu
from rrmpg_jax.ops.pallas_hbv import hbv_ensemble_mse_pallas


def _inputs(T=300, N=1024, seed=3):
    rng = np.random.default_rng(seed)
    temp = jnp.asarray(rng.uniform(-15, 25, T))
    prec = jnp.asarray(rng.uniform(0, 20, T))
    month = jnp.asarray(rng.integers(0, 12, T))
    qobs = jnp.asarray(rng.uniform(0, 3, T))
    pe_m = jnp.asarray(rng.uniform(0, 4, 12))
    t_m = jnp.asarray(rng.uniform(-5, 15, 12))
    params = {k: jnp.asarray(v) for k, v in {
        'T_t': rng.uniform(-1, 1, N), 'DD': rng.uniform(3, 7, N),
        'FC': rng.uniform(100, 200, N), 'Beta': rng.uniform(1, 7, N),
        'C': rng.uniform(0.01, 0.07, N), 'PWP': rng.uniform(90, 180, N),
        'K_0': rng.uniform(0.05, 0.2, N), 'K_1': rng.uniform(0.01, 0.1, N),
        'K_2': rng.uniform(0.01, 0.05, N),
        'K_p': rng.uniform(0.01, 0.05, N),
        'L': rng.uniform(2, 5, N)}.items()}
    return temp, prec, month, pe_m, t_m, qobs, params


def test_hbv_mse_kernel_matches_xla():
    temp, prec, month, pe_m, t_m, qobs, params = _inputs()
    mse_p = hbv_ensemble_mse_pallas(temp, prec, month, pe_m, t_m, qobs,
                                    0.0, 100.0, 3.0, 10.0, params,
                                    interpret=True)
    q_x = jax.vmap(lambda p: run_hbvedu(temp, prec, month, pe_m, t_m, 0.0,
                                        100.0, 3.0, 10.0, p)[0])(params)
    mse_x = jnp.mean((q_x - qobs[None, :]) ** 2, axis=1)
    assert np.allclose(np.asarray(mse_p), np.asarray(mse_x))


def test_hbv_mse_kernel_member_padding():
    temp, prec, month, pe_m, t_m, qobs, params = _inputs(T=130, N=70)
    mse_p = hbv_ensemble_mse_pallas(temp, prec, month, pe_m, t_m, qobs,
                                    0.0, 100.0, 3.0, 10.0, params,
                                    interpret=True)
    assert mse_p.shape == (70,)
    q_x = jax.vmap(lambda p: run_hbvedu(temp, prec, month, pe_m, t_m, 0.0,
                                        100.0, 3.0, 10.0, p)[0])(params)
    mse_x = jnp.mean((q_x - qobs[None, :]) ** 2, axis=1)
    assert np.allclose(np.asarray(mse_p), np.asarray(mse_x))


@pytest.mark.slow
def test_hbv_simulate_pallas_matches_xla():
    import jax.numpy as jnp
    from rrmpg_jax.ops.hbvedu import run_hbvedu
    from rrmpg_jax.ops.pallas_hbv import hbv_simulate_pallas

    rng = np.random.default_rng(21)
    T, N = 400, 5
    temp = jnp.asarray(rng.uniform(-10, 25, T))
    prec = jnp.asarray(rng.uniform(0, 15, T))
    month = jnp.asarray(rng.integers(0, 12, T))
    pe_m = jnp.asarray(rng.uniform(1, 4, 12))
    t_m = jnp.asarray(rng.uniform(-5, 20, 12))
    params = {
        'T_t': jnp.asarray(rng.uniform(-1, 1, N)),
        'DD': jnp.asarray(rng.uniform(3, 7, N)),
        'FC': jnp.asarray(rng.uniform(100, 200, N)),
        'Beta': jnp.asarray(rng.uniform(1, 7, N)),
        'C': jnp.asarray(rng.uniform(0.01, 0.07, N)),
        'PWP': jnp.asarray(rng.uniform(90, 180, N)),
        'K_0': jnp.asarray(rng.uniform(0.05, 0.2, N)),
        'K_1': jnp.asarray(rng.uniform(0.01, 0.1, N)),
        'K_2': jnp.asarray(rng.uniform(0.01, 0.05, N)),
        'K_p': jnp.asarray(rng.uniform(0.01, 0.05, N)),
        'L': jnp.asarray(rng.uniform(2, 5, N)),
    }
    q_p = hbv_simulate_pallas(temp, prec, month, pe_m, t_m, 5.0, 120.0,
                              1.0, 1.0, params, 
                              interpret=True)
    for i in range(N):
        p_i = {k: v[i] for k, v in params.items()}
        q_x, *_ = run_hbvedu(temp, prec, month, pe_m, t_m, 5.0, 120.0,
                             1.0, 1.0, p_i)
        assert np.allclose(np.asarray(q_p[i]), np.asarray(q_x),
                           rtol=1e-6, atol=1e-8)


def test_hbv_class_pallas_engine():
    from rrmpg_jax.models import HBVEdu

    model = HBVEdu()
    rng = np.random.default_rng(3)
    T = 200
    kwargs = dict(temp=rng.uniform(-5, 20, T), prec=rng.uniform(0, 10, T),
                  month=rng.integers(1, 13, T).astype(np.int64),
                  PE_m=rng.uniform(1, 4, 12), T_m=rng.uniform(0, 15, 12),
                  snow_init=2.0, soil_init=100.0)
    params = model.get_random_params(num=3)
    q_x = model.simulate(params=params, **kwargs)
    q_p = model.simulate(params=params, engine="pallas", interpret=True,
                         **kwargs)
    assert q_p.shape == q_x.shape
    assert np.allclose(q_p, q_x, rtol=1e-6, atol=1e-8)


def test_hbv_stats_variant_matches_trajectory():
    """stats=True equals the statistics of the fused trajectory."""
    import jax.numpy as jnp

    from rrmpg_jax.ops.pallas_hbv import (
        hbv_ensemble_mse_pallas,
        hbv_simulate_pallas,
    )

    rng = np.random.default_rng(0)
    T, N = 150, 16
    temp = jnp.asarray(rng.uniform(-10, 20, T))
    prec = jnp.asarray(rng.uniform(0, 12, T))
    month = jnp.asarray(rng.integers(0, 12, T))
    pe_m = jnp.asarray(rng.uniform(1, 4, 12))
    t_m = jnp.asarray(rng.uniform(-5, 15, 12))
    qobs = jnp.asarray(rng.uniform(0, 5, T))
    from rrmpg_jax.models import HBVEdu
    params = {k: jnp.asarray(rng.uniform(lo, hi, N)) for k, (lo, hi)
              in HBVEdu._default_bounds.items()}

    stats = np.asarray(hbv_ensemble_mse_pallas(
        temp, prec, month, pe_m, t_m, qobs, 0.0, 0.0, 0.0, 0.0,
        params, interpret=True, stats=True))
    assert stats.shape == (4, N)
    qsim = np.asarray(hbv_simulate_pallas(
        temp, prec, month, pe_m, t_m, 0.0, 0.0, 0.0, 0.0, params,
        interpret=True))
    qo = np.asarray(qobs)
    np.testing.assert_allclose(stats[0],
                               np.mean((qsim - qo) ** 2, axis=1),
                               rtol=1e-6)
    np.testing.assert_allclose(stats[1], qsim.mean(axis=1), rtol=1e-6)
    np.testing.assert_allclose(stats[3], (qsim * qo).mean(axis=1),
                               rtol=1e-6)


def test_hbv_simulate_pallas_state_roundtrip():
    """Fused forecast mode: split run == unbroken run, exactly as the
    XLA warm kernel; cold final state matches run_hbvedu(return_final)."""
    from rrmpg_jax.ops.hbvedu import run_hbvedu
    from rrmpg_jax.ops.pallas_hbv import hbv_simulate_pallas_state

    temp, prec, month, pe_m, t_m, qobs, params = _inputs(T=300, N=6,
                                                         seed=9)
    inits = (5.0, 120.0, 1.0, 1.0)
    q_full, final_full = hbv_simulate_pallas_state(
        temp, prec, month, pe_m, t_m, *inits, params, 
        interpret=True)
    # Cold trajectory + final state vs the XLA reference kernel.
    for i in range(3):
        p_i = {k: v[i] for k, v in params.items()}
        out = run_hbvedu(temp, prec, month, pe_m, t_m, *inits, p_i,
                         return_final=True)
        q_x, fin_x = out[0], out[-1]
        assert np.allclose(np.asarray(q_full[i]), np.asarray(q_x),
                           rtol=1e-6, atol=1e-8)
        for got, exp in zip((final_full.snow[i], final_full.soil[i],
                             final_full.s1[i], final_full.s2[i]), fin_x):
            assert np.isclose(float(got), float(exp), rtol=1e-6)

    # Warm continuation: segment A (cold) then segment B from A's state
    # must equal the unbroken run.
    half = 150
    q_a, state_a = hbv_simulate_pallas_state(
        temp[:half], prec[:half], month[:half], pe_m, t_m, *inits,
        params, interpret=True)
    q_b, state_b = hbv_simulate_pallas_state(
        temp[half:], prec[half:], month[half:], pe_m, t_m, 0, 0, 0, 0,
        params, interpret=True, state=state_a)
    q_chained = np.concatenate([np.asarray(q_a), np.asarray(q_b)],
                               axis=1)
    assert np.allclose(q_chained, np.asarray(q_full), rtol=1e-6,
                       atol=1e-8)
    for leaf, ref in zip(state_b, final_full):
        assert np.allclose(np.asarray(leaf), np.asarray(ref), rtol=1e-6)


def test_hbv_class_pallas_forecast_mode():
    from rrmpg_jax.models import HBVEdu

    model = HBVEdu()
    rng = np.random.default_rng(13)
    T = 240
    kwargs = dict(PE_m=rng.uniform(1, 4, 12), T_m=rng.uniform(0, 15, 12))
    temp = rng.uniform(-5, 20, T)
    prec = rng.uniform(0, 10, T)
    month = rng.integers(1, 13, T).astype(np.int64)
    params = model.get_random_params(num=3)
    q_ref, final_ref = model.simulate(temp, prec, month, params=params,
                                      return_final_state=True, **kwargs)
    q_hist, st = model.simulate(temp[:160], prec[:160], month[:160],
                                params=params, engine="pallas",
                                interpret=True,
                                return_final_state=True, **kwargs)
    q_fc = model.simulate(temp[160:], prec[160:], month[160:],
                          params=params, engine="pallas", interpret=True,
                          initial_state=st, **kwargs)
    d = np.abs(np.concatenate([q_hist, q_fc]) - q_ref).max()
    from lane import tol
    assert d < tol(1e-6, 1e-5)


@pytest.mark.slow
def test_hbv_fit_initial_state_pallas_matches_xla():
    """fit(initial_state=, engine='pallas') agrees with the XLA warm fit
    and recovers the truth on a continuation segment."""
    from rrmpg_jax.models import HBVEdu

    rng = np.random.default_rng(17)
    T = 400
    truth = {'T_t': 0.5, 'DD': 4.0, 'FC': 150.0, 'Beta': 3.0,
             'C': 0.03, 'PWP': 120.0, 'K_0': 0.1, 'K_1': 0.05,
             'K_2': 0.02, 'K_p': 0.03, 'L': 3.0}
    model = HBVEdu(params=truth)
    temp = rng.uniform(-5, 20, T)
    prec = rng.uniform(0, 10, T)
    month = rng.integers(1, 13, T).astype(np.int64)
    kwargs = dict(PE_m=rng.uniform(1, 4, 12), T_m=rng.uniform(0, 15, 12))
    q_all, state = model.simulate(temp[:250], prec[:250], month[:250],
                                  snow_init=3.0, soil_init=120.0,
                                  return_final_state=True, **kwargs)
    qobs = np.asarray(model.simulate(
        temp[250:], prec[250:], month[250:], initial_state=state,
        **kwargs))[:, 0]

    res_p = model.fit(qobs, temp[250:], prec[250:], month[250:],
                      kwargs['PE_m'], kwargs['T_m'],
                      initial_state=state, engine="pallas",
                      interpret=True, seed=0, maxiter=30)
    res_x = model.fit(qobs, temp[250:], prec[250:], month[250:],
                      kwargs['PE_m'], kwargs['T_m'],
                      initial_state=state, engine="xla", seed=0,
                      maxiter=30)
    assert np.isfinite(res_p.fun)
    # Same seed, same objective values -> the evolutions must agree.
    np.testing.assert_allclose(res_p.fun, res_x.fun, rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(res_p.x, res_x.x, rtol=1e-4, atol=1e-6)
