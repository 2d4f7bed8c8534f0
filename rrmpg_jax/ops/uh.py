"""GR4J unit-hydrograph ordinates under static shapes.

The reference allocates parameter-dependent buffer lengths
``ceil(x4)`` / ``ceil(2*x4+1)`` at runtime (``rrmpg/models/gr4j_model.py:67-69``),
which is incompatible with XLA's static-shape compilation model.  Here the
ordinates are evaluated over *fixed* maximum lengths derived from the widest
published parameter bounds (x4 <= 10, ``rrmpg/models/cemaneigehystgr4j.py:69``).

No masking is needed: the S-curves SH1/SH2 saturate at 1 for t >= x4
(resp. t >= 2*x4), so all ordinates beyond the reference's dynamic lengths
are exactly zero and padded convolutions reproduce the dynamic-length result
bit-for-bit.
"""

import numpy as np

import jax.numpy as jnp
from jax import lax

# Widest x4 upper bound across the model family (CemaneigeHystGR4J uses
# x4 in (1.1, 10), rrmpg/models/cemaneigehystgr4j.py:69).
MAX_X4 = 10.0
NUM_UH1 = int(MAX_X4)            # ceil(x4)       <= 10
NUM_UH2 = int(2 * MAX_X4 + 1)    # ceil(2*x4 + 1) <= 21


def required_uh_lengths(x4_values):
    """Static UH register lengths covering every x4 in ``x4_values``.

    The reference allocates ``ceil(x4)`` / ``ceil(2*x4+1)`` dynamically per
    run (``gr4j_model.py:67-69``); under jit the lengths must be static, so
    model classes derive them host-side from the actual parameter batch
    (one recompile per distinct length).  Using buffers shorter than these
    would silently truncate the hydrograph and lose routed water.
    """
    x4_max = float(np.max(np.asarray(x4_values)))
    n1 = max(int(np.ceil(x4_max)), 1)
    n2 = max(int(np.ceil(2.0 * x4_max + 1.0)), 1)
    return max(n1, NUM_UH1), max(n2, NUM_UH2)


def s_curve1(t, x4):
    """SH1 S-curve (reference ``gr4j_model.py:159-173``), vectorized.

    Assumes t >= 0 (ordinate evaluation only uses integer t >= 0).
    """
    t = jnp.asarray(t)
    frac = jnp.clip(t / x4, 0.0, 1.0)
    return jnp.where(t <= 0, 0.0, frac ** 2.5)


def s_curve2(t, x4):
    """SH2 S-curve (reference ``gr4j_model.py:176-192``), vectorized."""
    t = jnp.asarray(t)
    ratio = t / x4
    rising = 0.5 * jnp.clip(ratio, 0.0, 1.0) ** 2.5
    falling = 1.0 - 0.5 * jnp.clip(2.0 - ratio, 0.0, 1.0) ** 2.5
    out = jnp.where(t <= x4, rising, falling)
    return jnp.where(t <= 0, 0.0, out)


def uh_ordinates(x4, dtype=None, num_uh1: int = NUM_UH1,
                 num_uh2: int = NUM_UH2):
    """Compute padded UH1/UH2 ordinates for one x4 value.

    Returns:
        (oh1, oh2): arrays of static shapes (num_uh1,), (num_uh2,);
        entries beyond ceil(x4) / ceil(2*x4+1) are exactly zero.
    """
    dtype = dtype or jnp.result_type(float)
    j1 = jnp.arange(1, num_uh1 + 1, dtype=dtype)
    j2 = jnp.arange(1, num_uh2 + 1, dtype=dtype)
    oh1 = s_curve1(j1, x4) - s_curve1(j1 - 1.0, x4)
    oh2 = s_curve2(j2, x4) - s_curve2(j2 - 1.0, x4)
    return oh1, oh2


def causal_fir(x, taps):
    """Causal FIR filter: ``y[t] = sum_j taps[j] * x[t-j]``.

    The reference implements this as a stateful shift-register update inside
    the time loop (``gr4j_model.py:130-136``); here it is a dense
    convolution the XLA compiler can tile and batch (and fuse with
    neighboring elementwise work), freeing the sequential scans from
    carrying the UH buffers.  The convolution runs at full float32
    precision (a GPU may otherwise run float32 products in TF32).
    """
    T = x.shape[0]
    return jnp.convolve(x, taps, precision=lax.Precision.HIGHEST)[:T]
