"""Fused kernels compiled for the card, against the ``xla`` engine.

Every variant of the Triton-route kernels (trajectory, forecast state,
masked and warm objectives, sufficient and Q+SCA statistics, regional,
snow-only, explicit member blocks) compiled for the GPU and run
at a few hundred members -- three member blocks and a padded tail --
in float32.  The CPU suite checks the same programs in the Pallas
interpreter; these checks need the card and skip without one.
``python chip_smoke.py`` runs them in its own process (phase 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.ops import (
    run_cemaneige,
    run_cemaneigehystgr4jice,
    run_gr4j,
    run_hbvedu,
)
from rrmpg_jax.ops.pallas_gr4j import (
    gr4j_ensemble_mse_pallas,
    gr4j_regional_mse_pallas,
    gr4j_simulate_pallas,
    gr4j_simulate_pallas_state,
)
from rrmpg_jax.ops.pallas_hbv import (
    hbv_ensemble_mse_pallas,
    hbv_simulate_pallas_state,
)
from rrmpg_jax.ops.pallas_snow import (
    cemaneige_simulate_pallas,
    snowgr4j_ensemble_mse_pallas,
    snowgr4j_simulate_pallas_state,
)

T, N, L = 400, 300, 5
# Float32 against float32 in another operation order (see chip_smoke.py).
RTOL, ATOL = 5e-3, 1e-3


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


def _rng():
    return np.random.default_rng(2024)


def _gr4j_inputs():
    rng = _rng()
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = {'x1': f(rng.uniform(100, 1200, N)),
              'x2': f(rng.uniform(-5, 3, N)),
              'x3': f(rng.uniform(20, 300, N)),
              'x4': f(rng.uniform(1.1, 9.9, N))}
    return (f(rng.uniform(0, 15, T)), f(rng.uniform(0, 4, T)),
            f(rng.uniform(0, 5, T)), params)


def _snow_inputs():
    rng = _rng()
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = {k: f(v) for k, v in {
        'CTG': rng.uniform(0, 1, N), 'Kf': rng.uniform(0, 10, N),
        'Thacc': rng.uniform(1, 100, N), 'Rsp': rng.uniform(0, 1, N),
        'x1': rng.uniform(10, 1200, N), 'x2': rng.uniform(-5, 3, N),
        'x3': rng.uniform(20, 5000, N), 'x4': rng.uniform(1.1, 9.9, N),
        'DDF': rng.uniform(0, 30, N)}.items()}
    return (f(rng.uniform(0, 15, (T, L))), f(rng.uniform(-12, 18, (T, L))),
            f(np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1)),
            f(rng.uniform(0, 4, T)), f(rng.uniform(1, 5, T)),
            f(rng.uniform(0, 0.7, L)), params)


def _hbv_inputs():
    rng = _rng()
    f = lambda a: jnp.asarray(a, jnp.float32)
    params = {k: f(rng.uniform(lo, hi, N)) for k, (lo, hi) in {
        'T_t': (-1, 1), 'DD': (3, 7), 'FC': (100, 200), 'Beta': (1, 7),
        'C': (0.01, 0.07), 'PWP': (90, 180), 'K_0': (0.05, 0.2),
        'K_1': (0.01, 0.1), 'K_2': (0.01, 0.05), 'K_p': (0.01, 0.05),
        'L': (2, 5)}.items()}
    month = jnp.asarray(np.arange(T) // 31 % 12)
    return (f(rng.uniform(-10, 20, T)), f(rng.uniform(0, 15, T)), month,
            f(rng.uniform(0.5, 4, 12)), f(rng.uniform(-5, 18, 12)),
            f(rng.uniform(0, 5, T)), params)


def _xla_mse(qsim, qobs):
    valid = jnp.isfinite(qobs)
    d = jnp.where(valid[None, :], qsim - jnp.where(valid, qobs, 0.0), 0.0)
    return jnp.sum(d * d, axis=1) / jnp.sum(valid)


def gr4j_trajectory():
    prec, etp, _, params = _gr4j_inputs()
    got = gr4j_simulate_pallas(prec, etp, 0.4, 0.3, params)
    want = jax.vmap(lambda p: run_gr4j(prec, etp, 0.4, 0.3, p)[0])(params)
    return [(got, want)]


def gr4j_forecast_state():
    prec, etp, _, params = _gr4j_inputs()
    q_a, state = gr4j_simulate_pallas_state(prec[:150], etp[:150], params,
                                            s_init=0.4, r_init=0.3)
    q_b, _ = gr4j_simulate_pallas_state(prec[150:], etp[150:], params,
                                        state=state)
    want = jax.vmap(lambda p: run_gr4j(prec, etp, 0.4, 0.3, p)[0])(params)
    return [(jnp.concatenate([q_a, q_b], axis=1), want)]


def gr4j_masked_mse():
    prec, etp, qobs, params = _gr4j_inputs()
    qobs = qobs.at[::7].set(jnp.nan)
    got = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.4, 0.3, params,
                                   masked=True)
    q = jax.vmap(lambda p: run_gr4j(prec, etp, 0.4, 0.3, p)[0])(params)
    return [(got, _xla_mse(q, qobs))]


def gr4j_block_sizes():
    prec, etp, qobs, params = _gr4j_inputs()
    want = gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.4, 0.3, params)
    return [(gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.4, 0.3, params,
                                      block=b), want) for b in (32, 64, 256)]


def gr4j_regional_stats():
    prec, etp, qobs, params = _gr4j_inputs()
    scale = jnp.asarray([0.7, 1.0, 1.3], jnp.float32)[:, None]
    pr = prec[None] * scale
    et, qo = jnp.stack([etp] * 3), jnp.stack([qobs] * 3)
    got = gr4j_regional_mse_pallas(pr, et, qo, 0.4, 0.3, params, stats=True)
    q = jax.vmap(lambda p1: jax.vmap(lambda p: run_gr4j(
        p1, etp, 0.4, 0.3, p)[0])(params))(pr)            # (C, N, T)
    want = jnp.stack([jnp.mean((q - qobs) ** 2, -1), q.mean(-1),
                      (q * q).mean(-1), (q * qobs).mean(-1)])
    return [(got, want)]


def snow_statistics():
    prec, temp, frac, etp, qobs, frac_ice, params = _snow_inputs()
    got = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 2.0, -1.0, 0.4, 0.3, params,
        frac_ice=frac_ice, hyst=True, ice=True, stats=True)
    q = jax.vmap(lambda p: run_cemaneigehystgr4jice(
        prec, temp, etp, frac_ice, frac, 2.0, -1.0, 0.0, 0.4, 0.3,
        p)[0])(params)
    want = jnp.stack([jnp.mean((q - qobs) ** 2, 1), q.mean(1),
                      (q * q).mean(1), (q * qobs).mean(1)])
    return [(got, want)]


def snow_q_sca_statistics():
    prec, temp, frac, etp, qobs, frac_ice, params = _snow_inputs()
    ndsi = jnp.asarray(_rng().uniform(0, 100, (L, T)), jnp.float32)
    got = snowgr4j_ensemble_mse_pallas(
        prec, temp, etp, frac, qobs, 2.0, -1.0, 0.4, 0.3, params,
        frac_ice=frac_ice, ndsi=ndsi, hyst=True, ice=True, sca_stats=True)
    sca = jax.vmap(lambda p: run_cemaneigehystgr4jice(
        prec, temp, etp, frac_ice, frac, 2.0, -1.0, 0.0, 0.4, 0.3,
        p)[5])(params)                                     # (N, T, L)
    s100 = 100.0 * jnp.moveaxis(sca, 2, 0)                 # (L, N, T)
    nd = ndsi[:, None, :]
    want = jnp.stack([jnp.mean((s100 - nd) ** 2, -1), s100.mean(-1),
                      (s100 * s100).mean(-1), (s100 * nd).mean(-1)], 1)
    return [(got[4:], want.reshape(4 * L, N))]


def snow_forecast_state():
    from rrmpg_jax.ops import run_cemaneigehystgr4j_warm

    prec, temp, frac, etp, _, frac_ice, params = _snow_inputs()
    kw = dict(frac_ice=frac_ice, hyst=True, ice=True)
    q_a, state = snowgr4j_simulate_pallas_state(
        prec[:150], temp[:150], etp[:150], frac[:150], params,
        snow_pack_init=2.0, thermal_state_init=-1.0, s_init=0.4,
        r_init=0.3, **kw)
    q_b, _ = snowgr4j_simulate_pallas_state(
        prec[150:], temp[150:], etp[150:], frac[150:], params, state=state,
        **kw)
    want_a = jax.vmap(lambda p: run_cemaneigehystgr4jice(
        prec[:150], temp[:150], etp[:150], frac_ice, frac[:150], 2.0, -1.0,
        0.0, 0.4, 0.3, p)[0])(params)
    sg = state.snow

    def warm(p, g, etg, sca, swe, psol, gr):
        return run_cemaneigehystgr4j_warm(
            prec[150:], temp[150:], etp[150:], frac[150:],
            ((g, etg, sca, swe), gr), psol, p, frac_ice=frac_ice)[0]

    want_b = jax.vmap(warm)(params, sg.g, sg.etg, sg.sca, sg.swe_max,
                            sg.psol_annual, state.gr4j)
    return [(q_a, want_a), (q_b, want_b)]


def cemaneige_trajectory():
    prec, temp, frac, _, _, _, params = _snow_inputs()
    params = {'CTG': params['CTG'], 'Kf': params['Kf']}
    got = cemaneige_simulate_pallas(prec, temp, frac, 2.0, -1.0, params)
    want = jax.vmap(lambda p: run_cemaneige(prec, temp, frac, 2.0, -1.0,
                                            p)[0])(params)
    return [(got, want)]


def hbv_forecast_and_warm_mse():
    temp, prec, month, pe_m, t_m, qobs, params = _hbv_inputs()
    inits = (0.0, 100.0, 2.0, 10.0)
    q_a, state = hbv_simulate_pallas_state(
        temp[:150], prec[:150], month[:150], pe_m, t_m, *inits, params)
    q_b, _ = hbv_simulate_pallas_state(
        temp[150:], prec[150:], month[150:], pe_m, t_m, *inits, params,
        state=state)
    want = jax.vmap(lambda p: run_hbvedu(temp, prec, month, pe_m, t_m,
                                         *inits, p)[0])(params)
    warm = hbv_ensemble_mse_pallas(
        temp[150:], prec[150:], month[150:], pe_m, t_m, qobs[150:], *inits,
        params, state=state)
    return [(jnp.concatenate([q_a, q_b], axis=1), want),
            (warm, _xla_mse(want[:, 150:], qobs[150:]))]


CASES = [gr4j_trajectory, gr4j_forecast_state, gr4j_masked_mse,
         gr4j_block_sizes, gr4j_regional_stats, snow_statistics,
         snow_q_sca_statistics, snow_forecast_state, cemaneige_trajectory,
         hbv_forecast_and_warm_mse]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_fused_kernel_on_card(gpu, case):
    for got, want in case():
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
