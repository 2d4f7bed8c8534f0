"""First-order linear recurrences as matmuls (scan-via-Toeplitz).

Solves ``S[t] = alpha * S[t-1] + b[t]`` (constant coefficient) without a
sequential loop and without ``lax.associative_scan``:

* Split the series into chunks of length C.  Within a chunk,
  ``S[i] = alpha^(i+1) * s_start + sum_{j<=i} alpha^(i-j) b[j]`` -- the sum
  is a causal convolution with the geometric kernel, i.e. a product with a
  lower-triangular Toeplitz matrix ``M[i, j] = alpha^(i-j)``.  All chunks
  evaluate as ONE batched (T/C, C) x (C, C) matmul.
* The chunk-boundary states follow the same recurrence at stride C
  (coefficient ``alpha^C``), so the construction recurses on the (T/C,)
  chunk aggregates -- three levels reach 10M elements with C=128.

Beside ``associative_scan``: its odd/even recursion emits O(log T) strided
slice/concat stages -- a deep HLO graph that compiles slowly.  The
Toeplitz form is a handful of matmuls with static shapes and a fast
compile, and it batches/vmaps cleanly over ensembles (per-member
``alpha`` gives a batched matmul).  Which of the ABC engines is fastest
on a given card is measured, not assumed (``bench.py``).

Used by the ABC model (exactly linear storage,
``rrmpg/models/abcmodel_model.py:53-59``) and usable for any linear
sub-recurrence of other models.
"""

import jax.numpy as jnp
from jax import lax


def _toeplitz_lower(alpha, C, dtype):
    """(C, C) lower-triangular matrix M[i, j] = alpha^(i-j)."""
    i = lax.broadcasted_iota(jnp.int32, (C, C), 0)
    j = lax.broadcasted_iota(jnp.int32, (C, C), 1)
    diff = jnp.clip(i - j, 0, None)
    powers = jnp.asarray(alpha, dtype) ** diff.astype(dtype)
    return jnp.where(i >= j, powers, jnp.zeros((), dtype))


def linear_recurrence(alpha, b, s0, chunk: int = 128,
                      precision=lax.Precision.HIGHEST):
    """Solve S[k] = alpha * S[k-1] + b[k] for k = 0..n-1 with S[-1] = s0.

    Args:
        alpha: scalar recurrence coefficient.
        b: (n,) input series.
        s0: scalar initial state (the value *before* b[0] is applied).
        chunk: Toeplitz block size.
        precision: matmul precision (HIGHEST keeps full float32 accuracy;
            a GPU may otherwise run float32 products in TF32).

    Returns:
        (n,) array of states S[0..n-1].
    """
    b = jnp.asarray(b)
    dtype = b.dtype
    alpha = jnp.asarray(alpha, dtype)
    s0 = jnp.asarray(s0, dtype)
    n = b.shape[0]

    if n == 0:
        return b

    # Base case: single small matmul.
    if n <= chunk:
        M = _toeplitz_lower(alpha, n, dtype)
        conv = jnp.matmul(M, b, precision=precision)
        powers = alpha ** jnp.arange(1, n + 1, dtype=dtype)
        return conv + powers * s0

    # Pad to a multiple of the chunk size.
    m = -(-n // chunk)
    padded = m * chunk
    b_pad = jnp.pad(b, (0, padded - n))
    blocks = b_pad.reshape(m, chunk)

    M = _toeplitz_lower(alpha, chunk, dtype)
    # within[k, i] = sum_{j<=i} alpha^(i-j) * b[k*C + j]  -- one batched
    # matmul over all chunks.
    within = jnp.matmul(blocks, M.T, precision=precision)

    # Chunk-boundary states: same recurrence at stride C on the chunk
    # aggregates e[k] = within[k, C-1], coefficient alpha^C.
    e = within[:, -1]
    alpha_c = alpha ** jnp.asarray(chunk, dtype)
    starts_tail = linear_recurrence(alpha_c, e[:-1], s0, chunk=chunk,
                                    precision=precision)
    starts = jnp.concatenate([s0[None], starts_tail])  # (m,) S before chunk k

    powers = alpha ** jnp.arange(1, chunk + 1, dtype=dtype)
    S = within + powers[None, :] * starts[:, None]
    return S.reshape(padded)[:n]
