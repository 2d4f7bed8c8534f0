"""Warm-state continuation (forecast mode) tests.

Splitting a series and carrying the full state across the boundary must
reproduce the unbroken trajectory exactly -- the operational capability
the reference cannot express (its *_init args cover only the stores, not
the UH filter history).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.ops.gr4j import (GR4JState, gr4j_initial_state, run_gr4j,
                                run_gr4j_warm)
from rrmpg_jax.ops.hbvedu import run_hbvedu, run_hbvedu_warm

from lane import tol

PARAMS = {'x1': 320.0, 'x2': 1.1, 'x3': 90.0, 'x4': 2.3}


def _forcing(T=500, seed=3):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(0, 15, T)),
            jnp.asarray(rng.uniform(0, 4, T)))


def test_gr4j_warm_cold_start_equals_run_gr4j():
    prec, etp = _forcing()
    q0, s0, r0 = run_gr4j(prec, etp, 0.4, 0.6, PARAMS)
    state = gr4j_initial_state(0.4, 0.6, PARAMS, dtype=prec.dtype)
    q1, s1, r1, _ = run_gr4j_warm(prec, etp, state, PARAMS)
    assert np.allclose(np.asarray(q0), np.asarray(q1), rtol=tol(1e-12, 2e-3))
    assert np.allclose(np.asarray(s0), np.asarray(s1), rtol=tol(1e-12, 2e-3))
    assert np.allclose(np.asarray(r0), np.asarray(r1), rtol=tol(1e-12, 2e-3))


@pytest.mark.parametrize("split", [1, 17, 250, 499])
def test_gr4j_split_invariance(split):
    prec, etp = _forcing()
    state = gr4j_initial_state(0.3, 0.5, PARAMS, dtype=prec.dtype)
    q_full, s_full, r_full, _ = run_gr4j_warm(prec, etp, state, PARAMS)

    q_a, s_a, r_a, mid = run_gr4j_warm(prec[:split], etp[:split], state,
                                       PARAMS)
    q_b, s_b, r_b, _ = run_gr4j_warm(prec[split:], etp[split:], mid,
                                     PARAMS)
    # Different segment lengths compile to differently-vectorized convs/
    # scans, so equality is allclose-tight rather than bitwise.
    assert np.allclose(np.asarray(q_full), np.concatenate([q_a, q_b]),
                       rtol=tol(1e-12, 2e-3), atol=tol(1e-12, 1e-4))
    assert np.allclose(np.asarray(r_full), np.concatenate([r_a, r_b]),
                       rtol=tol(1e-12, 2e-3), atol=tol(1e-12, 1e-4))


HBV_PARAMS = {'T_t': 0.0, 'DD': 5.0, 'FC': 150.0, 'Beta': 2.0, 'C': 0.05,
              'PWP': 120.0, 'K_0': 0.1, 'K_1': 0.05, 'K_2': 0.02,
              'K_p': 0.03, 'L': 3.0}


def _hbv_forcing(T=400, seed=4):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(-10, 20, T)),
            jnp.asarray(rng.uniform(0, 12, T)),
            jnp.asarray(rng.integers(0, 12, T)),
            jnp.asarray(rng.uniform(1, 4, 12)),
            jnp.asarray(rng.uniform(-5, 15, 12)))


def test_hbv_warm_matches_reference_tail():
    # run_hbvedu treats index 0 as the init step; warm-running the tail
    # inputs from the same initial storages must reproduce outputs [1:].
    temp, prec, month, pe_m, t_m = _hbv_forcing()
    inits = (2.0, 100.0, 1.0, 1.0)
    ref = run_hbvedu(temp, prec, month, pe_m, t_m, *inits, HBV_PARAMS)
    warm = run_hbvedu_warm(temp[1:], prec[1:], month[1:], pe_m, t_m,
                           inits, HBV_PARAMS)
    for ref_series, warm_series in zip(ref, warm[:5]):
        assert np.allclose(np.asarray(ref_series)[1:],
                           np.asarray(warm_series))


@pytest.mark.slow
@pytest.mark.parametrize("split", [1, 100, 399])
def test_hbv_split_invariance(split):
    temp, prec, month, pe_m, t_m = _hbv_forcing()
    inits = (2.0, 100.0, 1.0, 1.0)
    full = run_hbvedu_warm(temp, prec, month, pe_m, t_m, inits,
                           HBV_PARAMS)
    a = run_hbvedu_warm(temp[:split], prec[:split], month[:split], pe_m,
                        t_m, inits, HBV_PARAMS)
    b = run_hbvedu_warm(temp[split:], prec[split:], month[split:], pe_m,
                        t_m, a[5], HBV_PARAMS)
    assert np.allclose(np.asarray(full[0]), np.concatenate([a[0], b[0]]),
                       rtol=tol(1e-12, 2e-3), atol=tol(1e-12, 1e-4))
    assert np.allclose(np.asarray(full[2]), np.concatenate([a[2], b[2]]),
                       rtol=tol(1e-12, 2e-3), atol=tol(1e-12, 1e-4))


def test_cemaneige_split_invariance():
    from rrmpg_jax.ops.cemaneige import run_cemaneige, run_cemaneige_warm

    rng = np.random.default_rng(6)
    T, L = 300, 4
    prec = jnp.asarray(rng.uniform(0, 20, (T, L)))
    temp = jnp.asarray(rng.uniform(-10, 10, (T, L)))
    frac = jnp.asarray(rng.uniform(0, 1, (T, L)))
    params = {'CTG': 0.3, 'Kf': 4.0}

    # Cold reference run (init step at t=0 with G=eTG=2.0/-1.0).
    out, G, eTG = run_cemaneige(prec, temp, frac, 2.0, -1.0, params)
    g_thresh = 0.9 * 365.25 * jnp.mean(prec * frac, axis=0)

    # Warm-run the tail from the post-init state and compare to [1:].
    split = 120
    state = (G[split - 1], eTG[split - 1])
    out_w, G_w, eTG_w, final = run_cemaneige_warm(
        prec[split:], temp[split:], frac[split:], state, g_thresh, params)
    assert np.allclose(np.asarray(out_w), np.asarray(out[split:]),
                       rtol=tol(1e-12, 2e-3), atol=tol(1e-12, 1e-4))
    assert np.allclose(np.asarray(G_w), np.asarray(G[split:]),
                       rtol=tol(1e-12, 2e-3), atol=tol(1e-12, 1e-4))
    assert np.allclose(np.asarray(final[0]), np.asarray(G[-1]),
                       rtol=tol(1e-12, 2e-3))


def test_cemaneigehyst_split_invariance():
    from rrmpg_jax.ops.cemaneige import (run_cemaneigehyst,
                                         run_cemaneigehyst_warm)

    rng = np.random.default_rng(7)
    T, L = 300, 3
    prec = jnp.asarray(rng.uniform(0, 20, (T, L)))
    temp = jnp.asarray(rng.uniform(-10, 10, (T, L)))
    frac = jnp.asarray(rng.uniform(0, 1, (T, L)))
    params = {'CTG': 0.3, 'Kf': 4.0, 'Thacc': 60.0, 'Rsp': 0.25}

    out, G, eTG, sca, rain = run_cemaneigehyst(prec, temp, frac, 1.0,
                                               -0.5, 0.0, params)
    psol = 365.25 * jnp.mean(prec * frac, axis=0)

    split = 150
    # swe_max is internal carry state, not a returned series; reconstruct
    # it by warm-running from the start (t=0 state matches the cold run's
    # post-init values: G/eTG init, sca/swe_max zero -- the cold kernel's
    # t=0 step consumes the inits and zero sca/swe carries).
    state0 = (jnp.full((L,), 1.0) ,
              jnp.full((L,), 0.0), jnp.zeros(L), jnp.zeros(L))
    # Cold t=0: G := snow_pack_init, eTG := min(thermal_init, 0) BEFORE
    # melt; emulate by warm-running with the first step's forcing given a
    # pre-state whose update reproduces it is not possible in general, so
    # instead verify warm-vs-warm split invariance:
    full = run_cemaneigehyst_warm(prec, temp, frac, state0, psol, params)
    a = run_cemaneigehyst_warm(prec[:split], temp[:split], frac[:split],
                               state0, psol, params)
    b = run_cemaneigehyst_warm(prec[split:], temp[split:], frac[split:],
                               a[5], psol, params)
    assert np.allclose(np.asarray(full[0]),
                       np.concatenate([a[0], b[0]]), rtol=tol(1e-12, 2e-3),
                       atol=tol(1e-12, 1e-4))
    assert np.allclose(np.asarray(full[3]),
                       np.concatenate([a[3], b[3]]), rtol=tol(1e-12, 2e-3),
                       atol=tol(1e-12, 1e-4))
    # And the warm kernel's physics agrees with the cold kernel away from
    # the init step when started from the cold run's carried state
    # (sca/swe_max reconstructed by replaying to the split).
    swe_at_split = _swe_at(prec, temp, frac, params, psol, split,
                           (out, G, eTG, sca))
    warm_from_cold = run_cemaneigehyst_warm(
        prec[split:], temp[split:], frac[split:],
        (G[split - 1], eTG[split - 1], sca[split - 1], swe_at_split),
        psol, params)
    assert np.allclose(np.asarray(warm_from_cold[0]),
                       np.asarray(out[split:]), rtol=1e-10, atol=1e-10)


def _swe_at(prec, temp, frac, params, psol, split, cold_outputs):
    # Reconstruct swe_max (internal carry, not a returned series) at the
    # split: derive its value after the cold kernel's t=0 init step, then
    # replay forward with the warm kernel.  Cold t=0 used
    # snow_pack_init=1.0; the accumulation branch decides from the t=0
    # snow balance with swe_max_prev=0.
    from rrmpg_jax.ops.cemaneige import run_cemaneigehyst_warm

    out, G, eTG, sca = cold_outputs
    snow0 = (prec * frac)[0]
    g_before_melt0 = jnp.asarray(1.0) + 0.0 * snow0  # G init
    accum0 = (snow0 - (g_before_melt0 - G[0])) >= 0  # melt0 = Gb - G[0]
    swe0 = jnp.where(accum0, jnp.maximum(0.0, g_before_melt0), 0.0)
    swe0 = jnp.where(G[0] == 0.0, 0.0, swe0)
    state = (G[0], eTG[0], sca[0], swe0)
    if split == 1:
        return state[3]
    res = run_cemaneigehyst_warm(prec[1:split], temp[1:split],
                                 frac[1:split], state, psol, params)
    return res[5][3]


@pytest.mark.slow
def test_gr4j_warm_split_fuzz():
    # Random parameters x random split points: chained segments must
    # always reproduce the unbroken trajectory.
    rng = np.random.default_rng(42)
    for trial in range(10):
        T = int(rng.integers(50, 800))
        prec = jnp.asarray(rng.uniform(0, 15, T))
        etp = jnp.asarray(rng.uniform(0, 4, T))
        params = {'x1': float(rng.uniform(100, 1200)),
                  'x2': float(rng.uniform(-5, 3)),
                  'x3': float(rng.uniform(20, 300)),
                  'x4': float(rng.uniform(1.1, 2.9))}
        split = int(rng.integers(1, T))
        state = gr4j_initial_state(float(rng.uniform(0, 1)),
                                   float(rng.uniform(0, 1)), params,
                                   dtype=prec.dtype)
        q_full, _, _, _ = run_gr4j_warm(prec, etp, state, params)
        q_a, _, _, mid = run_gr4j_warm(prec[:split], etp[:split], state,
                                       params)
        q_b, _, _, _ = run_gr4j_warm(prec[split:], etp[split:], mid,
                                     params)
        assert np.allclose(np.asarray(q_full),
                           np.concatenate([q_a, q_b]),
                           rtol=tol(1e-11, 1e-4),
                           atol=tol(1e-11, 1e-4)), (trial, T, split)


@pytest.mark.slow
def test_composition_warm_split_invariance():
    from rrmpg_jax.ops.compositions import (run_cemaneigegr4j_warm,
                                            run_cemaneigehystgr4j_warm)
    from rrmpg_jax.ops.gr4j import gr4j_initial_state

    rng = np.random.default_rng(9)
    T, L = 250, 3
    prec = jnp.asarray(rng.uniform(0, 20, (T, L)))
    temp = jnp.asarray(rng.uniform(-10, 10, (T, L)))
    frac = jnp.asarray(rng.uniform(0, 1, (T, L)))
    etp = jnp.asarray(rng.uniform(0, 4, T))
    fi = jnp.asarray(rng.uniform(0, 0.5, L))
    params = {'CTG': 0.3, 'Kf': 4.0, 'Thacc': 60.0, 'Rsp': 0.25,
              'x1': 300.0, 'x2': 1.0, 'x3': 90.0, 'x4': 2.0,
              'DDF': 6.0}
    g_thresh = 0.9 * 365.25 * jnp.mean(prec * frac, axis=0)
    psol = 365.25 * jnp.mean(prec * frac, axis=0)
    zl = jnp.zeros(L)

    # plain + ice variant
    state0 = ((zl + 2.0, zl), gr4j_initial_state(0.3, 0.5, params,
                                                 num_uh2=7,
                                                 dtype=prec.dtype))
    full = run_cemaneigegr4j_warm(prec, temp, etp, frac, state0, g_thresh,
                                  params, num_uh1=3, num_uh2=7,
                                  frac_ice=fi)
    split = 117
    a = run_cemaneigegr4j_warm(prec[:split], temp[:split], etp[:split],
                               frac[:split], state0, g_thresh, params,
                               num_uh1=3, num_uh2=7, frac_ice=fi)
    b = run_cemaneigegr4j_warm(prec[split:], temp[split:], etp[split:],
                               frac[split:], a[6], g_thresh, params,
                               num_uh1=3, num_uh2=7, frac_ice=fi)
    assert np.allclose(np.asarray(full[0]),
                       np.concatenate([a[0], b[0]]), rtol=tol(1e-11, 1e-4),
                       atol=tol(1e-11, 1e-4))
    assert np.asarray(full[5]).max() >= 0.0       # icemelt diagnostic

    # plain (no-ice) path: icemelt must be zeros and splits must chain.
    full_p = run_cemaneigegr4j_warm(prec, temp, etp, frac, state0,
                                    g_thresh, params, num_uh1=3,
                                    num_uh2=7)
    a_p = run_cemaneigegr4j_warm(prec[:split], temp[:split], etp[:split],
                                 frac[:split], state0, g_thresh, params,
                                 num_uh1=3, num_uh2=7)
    b_p = run_cemaneigegr4j_warm(prec[split:], temp[split:], etp[split:],
                                 frac[split:], a_p[6], g_thresh, params,
                                 num_uh1=3, num_uh2=7)
    assert np.allclose(np.asarray(full_p[0]),
                       np.concatenate([a_p[0], b_p[0]]), rtol=tol(1e-11, 1e-4),
                       atol=tol(1e-11, 1e-4))
    assert np.all(np.asarray(full_p[5]) == 0.0)

    # hysteresis + ice variant
    state0 = ((zl + 2.0, zl, zl, zl),
              gr4j_initial_state(0.3, 0.5, params, num_uh2=7,
                                 dtype=prec.dtype))
    full = run_cemaneigehystgr4j_warm(prec, temp, etp, frac, state0,
                                      psol, params, num_uh1=3, num_uh2=7,
                                      frac_ice=fi)
    a = run_cemaneigehystgr4j_warm(prec[:split], temp[:split],
                                   etp[:split], frac[:split], state0,
                                   psol, params, num_uh1=3, num_uh2=7,
                                   frac_ice=fi)
    b = run_cemaneigehystgr4j_warm(prec[split:], temp[split:],
                                   etp[split:], frac[split:], a[8], psol,
                                   params, num_uh1=3, num_uh2=7,
                                   frac_ice=fi)
    assert np.allclose(np.asarray(full[0]),
                       np.concatenate([a[0], b[0]]), rtol=tol(1e-11, 1e-4),
                       atol=tol(1e-11, 1e-4))
