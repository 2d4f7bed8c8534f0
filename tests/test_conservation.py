"""Water-balance conservation tests.

Physical invariants the golden/fuzz layers don't assert directly: mass
entering each model must leave as discharge or remain in storage.  These
catch sign/clamp regressions in the kernels (a flipped melt cap or store
update breaks closure immediately) and double as a semantic check of the
forecast-mode state bundles -- the GR4J closure is only exact when the
in-flight unit-hydrograph mass is reconstructed from the carried
``pr_history``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.ops.abc import run_abcmodel, run_abcmodel_warm
from rrmpg_jax.ops.cemaneige import (
    run_cemaneige,
    run_cemaneige_warm,
    run_cemaneigehyst,
    run_cemaneigehyst_warm,
)
from rrmpg_jax.ops.gr4j import run_gr4j, run_gr4j_warm
from rrmpg_jax.ops.hbvedu import run_hbvedu
from rrmpg_jax.ops.uh import s_curve1, s_curve2

from lane import tol

T, L = 440, 3


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def test_abc_balance_exact(rng):
    """sum(q) + dS == (1 - b) * sum(P): only the loss term b*P leaves."""
    prec = jnp.asarray(rng.uniform(0, 20, T))
    p = {'a': 0.3, 'b': 0.2, 'c': 0.15}
    q, s = run_abcmodel(prec, 5.0, p)
    # t=0 is the init step (qsim[0]=0, storage[0]=init): balance over t>=1.
    lhs = float(jnp.sum(q[1:]) + s[-1] - s[0])
    rhs = float((1 - p['b']) * jnp.sum(prec[1:]))
    assert abs(lhs - rhs) < tol(1e-9, 2e-4) * rhs

    # warm kernel: every step participates.
    qw, sw, fin = run_abcmodel_warm(prec, 5.0, p)
    lhs = float(jnp.sum(qw) + fin - 5.0)
    rhs = float((1 - p['b']) * jnp.sum(prec))
    assert abs(lhs - rhs) < tol(1e-9, 2e-4) * rhs


def _layer_forcing(rng):
    lp = jnp.asarray(rng.uniform(0, 15, (T, L)))
    lt = jnp.asarray(rng.uniform(-15, 15, (T, L)))
    fs = jnp.asarray(rng.uniform(0, 1, (T, L)))
    return lp, lt, fs


def test_cemaneige_balance_exact(rng):
    """Per layer: sum(outflow contributions) == rain + (snow - dG)."""
    lp, lt, fs = _layer_forcing(rng)
    p = {'CTG': 0.25, 'Kf': 3.74}
    out, G, eTG, fin = run_cemaneige(lp, lt, fs, 0.0, 0.0, p,
                                     return_final=True)
    snow_in = jnp.sum((lp * fs)[1:], axis=0)      # t=0 is the init step
    rain_in = jnp.sum((lp - lp * fs)[1:], axis=0)
    melt = snow_in - (G[-1] - G[0])
    expected = float(jnp.sum(rain_in + melt))
    got = float(jnp.sum(out[1:]) * L)             # outflow = layer mean
    assert abs(expected - got) < tol(1e-9, 2e-4) * max(expected, 1.0)
    assert np.all(np.asarray(melt) >= -tol(1e-9, 1e-4))      # melt never negative

    # Warm continuation conserves over the segment with carried states.
    out_w, G_w, _, fin_w = run_cemaneige_warm(lp, lt, fs,
                                              (fin[0], fin[1]), fin[2], p)
    snow_in = jnp.sum(lp * fs, axis=0)
    rain_in = jnp.sum(lp - lp * fs, axis=0)
    melt = snow_in - (fin_w[0] - fin[0])
    expected = float(jnp.sum(rain_in + melt))
    got = float(jnp.sum(out_w) * L)
    assert abs(expected - got) < tol(1e-9, 2e-4) * max(expected, 1.0)


def test_cemaneigehyst_balance_exact(rng):
    """The SCA hysteresis bookkeeping must not create or destroy water."""
    lp, lt, fs = _layer_forcing(rng)
    p = {'CTG': 0.25, 'Kf': 3.74, 'Thacc': 300.0, 'Rsp': 0.3}
    out, G, eTG, sca, rain, fin = run_cemaneigehyst(
        lp, lt, fs, 0.0, 0.0, 0.0, p, return_final=True)
    snow_in = jnp.sum((lp * fs)[1:], axis=0)
    rain_in = jnp.sum((lp - lp * fs)[1:], axis=0)
    melt = snow_in - (G[-1] - G[0])
    expected = float(jnp.sum(rain_in + melt))
    got = float(jnp.sum(out[1:]) * L)
    assert abs(expected - got) < tol(1e-9, 2e-4) * max(expected, 1.0)

    out_w, G_w, _, _, _, fin_w = run_cemaneigehyst_warm(
        lp, lt, fs, fin[:4], fin[4], p)
    snow_in = jnp.sum(lp * fs, axis=0)
    rain_in = jnp.sum(lp - lp * fs, axis=0)
    melt = snow_in - (fin_w[0] - fin[0])
    expected = float(jnp.sum(rain_in + melt))
    got = float(jnp.sum(out_w) * L)
    assert abs(expected - got) < tol(1e-9, 2e-4) * max(expected, 1.0)


def _gr4j_in_flight(state, x4):
    """Mass inside the UH filters, from the carried routing history."""
    h = state.pr_history.shape[0]
    ages = jnp.arange(1, h + 1)
    hist = state.pr_history[::-1]        # hist[a-1] entered `a` steps ago
    remaining = (0.9 * (1.0 - s_curve1(ages, x4))
                 + 0.1 * (1.0 - s_curve2(ages, x4)))
    return float(jnp.sum(hist * remaining))


def test_gr4j_balance_exact_with_in_flight(rng):
    """With zero ET and zero groundwater exchange (x2=0), precipitation
    splits exactly into discharge + store changes + in-flight UH mass --
    the latter reconstructed from the forecast state's pr_history, so
    this also pins the state-bundle semantics."""
    prec = jnp.asarray(rng.uniform(0, 15, T))
    etp = jnp.zeros(T)
    p = {'x1': 320.0, 'x2': 0.0, 'x3': 90.0, 'x4': 2.3}
    q, s, r, st = run_gr4j(prec, etp, 0.3, 0.5, p, return_final=True)
    total_p = float(jnp.sum(prec))
    resid = (total_p - float(jnp.sum(q))
             - float(s[-1] - 0.3 * p['x1'])
             - float(r[-1] - 0.5 * p['x3'])
             - _gr4j_in_flight(st, p['x4']))
    assert abs(resid) < tol(1e-9, 2e-4) * total_p

    # And over a warm continuation segment: balance between the two
    # carried states.
    prec2 = jnp.asarray(rng.uniform(0, 15, T))
    q2, s2, r2, st2 = run_gr4j_warm(prec2, jnp.zeros(T), st, p)
    resid = (float(jnp.sum(prec2)) - float(jnp.sum(q2))
             - float(st2.s - st.s) - float(st2.r - st.r)
             - (_gr4j_in_flight(st2, p['x4'])
                - _gr4j_in_flight(st, p['x4'])))
    assert abs(resid) < tol(1e-9, 2e-4) * float(jnp.sum(prec2))


def test_gr4j_exchange_breaks_balance(rng):
    """Sanity that the invariant is sharp: a non-zero groundwater
    exchange (x2 != 0) must produce a clearly non-zero residual."""
    prec = jnp.asarray(rng.uniform(0, 15, T))
    etp = jnp.zeros(T)
    p = {'x1': 320.0, 'x2': 1.5, 'x3': 90.0, 'x4': 2.3}
    q, s, r, st = run_gr4j(prec, etp, 0.3, 0.5, p, return_final=True)
    total_p = float(jnp.sum(prec))
    resid = (total_p - float(jnp.sum(q))
             - float(s[-1] - 0.3 * p['x1'])
             - float(r[-1] - 0.5 * p['x3'])
             - _gr4j_in_flight(st, p['x4']))
    assert abs(resid) > 1e-3 * total_p


def test_hbv_near_closure_zero_et(rng):
    """HBV-Edu does not close exactly even at zero ET (the reference
    debits s1_prev*K1 but credits s1_t*K1 into discharge); pin the leak's
    smallness so a genuine sign/clamp regression still fails loudly."""
    HP = {'T_t': 0.0, 'DD': 5.0, 'FC': 150.0, 'Beta': 2.0, 'C': 0.05,
          'PWP': 120.0, 'K_0': 0.1, 'K_1': 0.05, 'K_2': 0.02,
          'K_p': 0.03, 'L': 3.0}
    temp = jnp.asarray(rng.uniform(-10, 20, T))
    prec = jnp.asarray(rng.uniform(0, 12, T))
    month = jnp.asarray(rng.integers(0, 12, T))
    pe_m = jnp.zeros(12)
    t_m = jnp.asarray(rng.uniform(-5, 15, 12))
    q, snow, soil, s1, s2 = run_hbvedu(temp, prec, month, pe_m, t_m,
                                       2.0, 100.0, 1.0, 1.0, HP)
    dstore = float((snow[-1] + soil[-1] + s1[-1] + s2[-1])
                   - (snow[0] + soil[0] + s1[0] + s2[0]))
    total_p = float(jnp.sum(prec[1:]))
    resid = total_p - float(jnp.sum(q[1:])) - dstore
    assert abs(resid) < 5e-3 * total_p
