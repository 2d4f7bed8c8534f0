"""ABC-model kernel (Fiering 1967).

State transition (reference ``rrmpg/models/abcmodel_model.py:53-59``)::

    qsim[t]    = (1 - a - b) * prec[t] + c * storage[t-1]
    storage[t] = (1 - c) * storage[t-1] + a * prec[t]

with ``storage[0] = initial_state`` and ``qsim[0] = 0`` (the reference loop
starts at t=1).

The recurrence is *linear* in the storage, so in addition to the
sequential ``lax.scan`` path there is a parallel-prefix path built on
``jax.lax.associative_scan``: the affine maps ``S -> A*S + B`` compose
associatively, giving O(log T) depth instead of a 10M-step sequential
loop, and a hierarchical Toeplitz matmul path (``ops/linear_scan.py``).
This is the headline speed benchmark of the reference (10M timesteps,
``docs/source/examples/speed_comparision.rst``).
"""

import jax.numpy as jnp
from jax import lax

from .linear_scan import linear_recurrence


def run_abcmodel(prec, initial_state, params, *, unroll: int = 8):
    """Simulate the ABC model for a single parameter set (sequential scan).

    Args:
        prec: (T,) precipitation series.
        initial_state: scalar initial storage.
        params: dict with scalar entries 'a', 'b', 'c'.
        unroll: scan unroll factor (XLA fuses the unrolled steps).

    Returns:
        (qsim, storage): two (T,) arrays.
    """
    prec = jnp.asarray(prec)
    a, b, c = params['a'], params['b'], params['c']
    s0 = jnp.asarray(initial_state, dtype=prec.dtype)

    def step(storage, p):
        q = (1.0 - a - b) * p + c * storage
        s_new = (1.0 - c) * storage + a * p
        return s_new, (q, s_new)

    _, (qsim, storage) = lax.scan(step, s0, prec[1:], unroll=unroll)
    zero = jnp.zeros((1,), dtype=prec.dtype)
    qsim = jnp.concatenate([zero, qsim])
    storage = jnp.concatenate([s0[None], storage])
    return qsim, storage


def run_abcmodel_pscan(prec, initial_state, params):
    """Simulate the ABC model via parallel prefix (associative scan).

    Mathematically identical to :func:`run_abcmodel` (floating-point
    reassociation aside): ``storage[t] = A^t * s0 + sum_k A^(t-k) B[k]``
    evaluated with a Blelloch-style scan over affine-map composition.

    O(log T) sequential depth for long series.
    """
    prec = jnp.asarray(prec)
    a, b, c = params['a'], params['b'], params['c']
    s0 = jnp.asarray(initial_state, dtype=prec.dtype)

    alpha = 1.0 - c
    # Affine maps for steps t = 1 .. T-1:  S_t = alpha * S_{t-1} + a * P_t
    A = jnp.full(prec.shape[0] - 1, alpha, dtype=prec.dtype)
    B = a * prec[1:]

    def compose(left, right):
        a1, b1 = left
        a2, b2 = right
        return a2 * a1, a2 * b1 + b2

    A_cum, B_cum = lax.associative_scan(compose, (A, B))
    storage_tail = A_cum * s0 + B_cum
    storage = jnp.concatenate([s0[None], storage_tail])

    qsim_tail = (1.0 - a - b) * prec[1:] + c * storage[:-1]
    qsim = jnp.concatenate([jnp.zeros((1,), dtype=prec.dtype), qsim_tail])
    return qsim, storage


def run_abcmodel_warm(prec, state, params):
    """Continue an ABC simulation from a carried storage value.

    Forecast/continuation mode: unlike the cold kernels (which follow the
    reference in treating index 0 as the initialization step with
    ``qsim[0] = 0``, ``storage[0] = initial_state``), every timestep here
    advances the model from ``state`` -- so splitting a series and chaining
    segments through the returned final storage reproduces the unbroken
    trajectory exactly.

    Built on the same Toeplitz ``linear_recurrence`` as
    :func:`run_abcmodel_matscan` (the storage recurrence is linear).

    Args:
        prec: (T,) continuation-segment precipitation.
        state: scalar carried storage (e.g. ``storage[-1]`` of a previous
            segment).
        params: dict with scalar entries 'a', 'b', 'c'.

    Returns:
        (qsim, storage, final_state) where the series are (T,) and
        ``final_state`` is the scalar storage after the last step.
    """
    prec = jnp.asarray(prec)
    a, b, c = params['a'], params['b'], params['c']
    s_prev = jnp.asarray(state, dtype=prec.dtype)

    storage = linear_recurrence(1.0 - c, a * prec, s_prev)
    s_shifted = jnp.concatenate([s_prev[None], storage[:-1]])
    qsim = (1.0 - a - b) * prec + c * s_shifted
    return qsim, storage, storage[-1]


def run_abcmodel_matscan(prec, initial_state, params):
    """Simulate the ABC model via hierarchical Toeplitz matmuls.

    Same trajectory as :func:`run_abcmodel`, computed with
    :func:`rrmpg_jax.ops.linear_scan.linear_recurrence`: the storage
    recurrence becomes batched lower-triangular matmuls (full float32
    precision).  Compact HLO (fast compile); also the best vmap target for
    large ensembles (per-member coefficients give one batched matmul).
    """
    prec = jnp.asarray(prec)
    a, b, c = params['a'], params['b'], params['c']
    s0 = jnp.asarray(initial_state, dtype=prec.dtype)

    storage_tail = linear_recurrence(1.0 - c, a * prec[1:], s0)
    storage = jnp.concatenate([s0[None], storage_tail])
    qsim_tail = (1.0 - a - b) * prec[1:] + c * storage[:-1]
    qsim = jnp.concatenate([jnp.zeros((1,), dtype=prec.dtype), qsim_tail])
    return qsim, storage
