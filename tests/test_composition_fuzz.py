"""Property-based fuzzing: JAX composition kernels vs C++ oracle chains.

Random parameter draws across the full bounds (including the hysteresis
and ice variants the golden CSVs only probe at one parameter point) must
match compositions of the independent C++ oracle kernels.
"""

import numpy as np
import pytest

from rrmpg_jax import native
from rrmpg_jax.ops import (
    run_cemaneigegr4j,
    run_cemaneigegr4jice,
    run_cemaneigehystgr4j,
    run_cemaneigehystgr4jice,
)

pytestmark = [
    pytest.mark.skipif(not native.available(),
                       reason="native toolchain unavailable"),
    # Bit-parity against the float64 C++ oracle is a float64 contract.
    pytest.mark.f64only,
]

RNG = np.random.default_rng(99)
T, L = 400, 5


@pytest.fixture(scope="module")
def forcing():
    prec = RNG.uniform(0, 15, (T, L))
    temp = RNG.uniform(-12, 18, (T, L))
    frac = np.clip(RNG.uniform(-0.3, 1.2, (T, L)), 0, 1)
    etp = RNG.uniform(0, 4, T)
    frac_ice = RNG.uniform(0, 0.8, L)
    return prec, temp, frac, etp, frac_ice


def _draw_params():
    return {'CTG': RNG.uniform(0, 1), 'Kf': RNG.uniform(0, 10),
            'Thacc': RNG.uniform(1, 1000), 'Rsp': RNG.uniform(0, 1),
            'x1': RNG.uniform(10, 1200), 'x2': RNG.uniform(-5, 3),
            'x3': RNG.uniform(20, 5000), 'x4': RNG.uniform(1.1, 9.9),
            'DDF': RNG.uniform(0, 30)}


def _oracle_chain(forcing, p, hyst, ice):
    prec, temp, frac, etp, frac_ice = forcing
    if hyst:
        melt, G, _, _, _ = native.oracle_cemaneigehyst(
            prec, temp, frac, 1.0, -0.5, 0.0, p)
    else:
        melt, G, _ = native.oracle_cemaneige(prec, temp, frac, 1.0, -0.5, p)
    if ice:
        icemelt = native.oracle_icemelt(temp, G, p)
        melt = melt + np.sum(icemelt * frac_ice[None, :], axis=1)
    q, _, _ = native.oracle_gr4j(melt, etp, 0.4, 0.3, p)
    return q


@pytest.mark.parametrize("hyst,ice,jax_fn", [
    (False, False, run_cemaneigegr4j),
    (True, False, run_cemaneigehystgr4j),
    (False, True, run_cemaneigegr4jice),
    (True, True, run_cemaneigehystgr4jice),
])
@pytest.mark.parametrize("draw", range(3))
def test_composition_fuzz(forcing, hyst, ice, jax_fn, draw):
    prec, temp, frac, etp, frac_ice = forcing
    p = _draw_params()
    args = [prec, temp, etp]
    if ice:
        args.append(frac_ice)
    args.append(frac)
    inits = [1.0, -0.5]
    if hyst:
        inits.append(0.0)   # sca_init
    inits += [0.4, 0.3]
    q_jax = np.asarray(jax_fn(*args, *inits, p)[0])
    q_cpp = _oracle_chain(forcing, p, hyst, ice)
    assert np.allclose(q_jax, q_cpp), (
        f"divergence for params {p} (hyst={hyst}, ice={ice})")
