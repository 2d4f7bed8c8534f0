"""Cross-validation of the JAX kernels against the native C++ oracle.

Two independent implementations (different language, different structure)
of the same published model equations must agree on random inputs --
catches shared-blind-spot bugs that golden CSVs (fixed parameters) miss.
"""

import numpy as np
import pytest

from rrmpg_jax import native
from rrmpg_jax.ops import (
    run_abcmodel,
    run_cemaneige,
    run_cemaneigehyst,
    run_gr4j,
    run_hbvedu,
    run_icemelt,
)

pytestmark = [
    pytest.mark.skipif(not native.available(),
                       reason="native toolchain unavailable"),
    # Bit-parity against the float64 C++ oracle is a float64 contract.
    pytest.mark.f64only,
]

RNG = np.random.default_rng(123)


def test_abc_oracle():
    prec = RNG.uniform(0, 20, 2000)
    params = {'a': 0.4, 'b': 0.3, 'c': 0.2}
    q_c, s_c = native.oracle_abc(prec, 4.0, params)
    q_j, s_j = run_abcmodel(prec, 4.0, params)
    assert np.allclose(q_c, np.asarray(q_j))
    assert np.allclose(s_c, np.asarray(s_j))


@pytest.mark.parametrize("x4", [1.13, 2.5, 4.0, 9.7])
def test_gr4j_oracle(x4):
    prec = RNG.uniform(0, 15, 1500)
    etp = RNG.uniform(0, 4, 1500)
    params = {'x1': 350.0, 'x2': 1.1, 'x3': 90.0, 'x4': x4}
    q_c, s_c, r_c = native.oracle_gr4j(prec, etp, 0.5, 0.4, params)
    q_j, s_j, r_j = run_gr4j(prec, etp, 0.5, 0.4, params)
    assert np.allclose(q_c, np.asarray(q_j))
    assert np.allclose(s_c, np.asarray(s_j))
    assert np.allclose(r_c, np.asarray(r_j))


def test_hbvedu_oracle():
    T = 1200
    temp = RNG.uniform(-15, 25, T)
    prec = RNG.uniform(0, 20, T)
    month = RNG.integers(0, 12, T)
    pe_m = RNG.uniform(0, 4, 12)
    t_m = RNG.uniform(-5, 15, 12)
    params = {'T_t': 0.5, 'DD': 4.0, 'FC': 150.0, 'Beta': 2.0, 'C': 0.05,
              'PWP': 120.0, 'K_0': 0.1, 'K_1': 0.05, 'K_2': 0.02,
              'K_p': 0.03, 'L': 3.0}
    outs_c = native.oracle_hbvedu(temp, prec, month, pe_m, t_m, 0, 100, 3,
                                  10, params)
    outs_j = run_hbvedu(temp, prec, month, pe_m, t_m, 0, 100, 3, 10,
                        params)
    for c, j in zip(outs_c, outs_j):
        assert np.allclose(c, np.asarray(j))


def _layer_forcing(T=1500, L=5):
    prec = RNG.uniform(0, 15, (T, L))
    temp = RNG.uniform(-12, 18, (T, L))
    frac = np.clip(RNG.uniform(-0.3, 1.2, (T, L)), 0, 1)
    return prec, temp, frac


def test_cemaneige_oracle():
    prec, temp, frac = _layer_forcing()
    params = {'CTG': 0.3, 'Kf': 3.5}
    out_c, G_c, eTG_c = native.oracle_cemaneige(prec, temp, frac, 10.0,
                                                -2.0, params)
    out_j, G_j, eTG_j = run_cemaneige(prec, temp, frac, 10.0, -2.0, params)
    assert np.allclose(out_c, np.asarray(out_j))
    assert np.allclose(G_c, np.asarray(G_j))
    assert np.allclose(eTG_c, np.asarray(eTG_j))


def test_cemaneigehyst_oracle():
    prec, temp, frac = _layer_forcing()
    params = {'CTG': 0.7, 'Kf': 4.0, 'Thacc': 25.0, 'Rsp': 0.3}
    outs_c = native.oracle_cemaneigehyst(prec, temp, frac, 5.0, -1.0, 0.2,
                                         params)
    outs_j = run_cemaneigehyst(prec, temp, frac, 5.0, -1.0, 0.2, params)
    for c, j in zip(outs_c, outs_j):
        assert np.allclose(c, np.asarray(j))


def test_icemelt_oracle():
    temp = RNG.uniform(-10, 15, (800, 5))
    snow = np.clip(RNG.uniform(-2, 10, (800, 5)), 0, None)
    params = {'DDF': 6.0}
    liq_c = native.oracle_icemelt(temp, snow, params)
    liq_j = run_icemelt(temp, snow, params)
    assert np.allclose(liq_c, np.asarray(liq_j))
