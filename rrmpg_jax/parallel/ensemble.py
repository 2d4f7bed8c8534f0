"""Sharded ensemble evaluation over a device mesh.

Turns a single-parameter-set kernel into a GSPMD-sharded ensemble program:
``vmap`` over the parameter axis, parameters sharded across the mesh's
ensemble axis, forcings replicated.  XLA partitions the scans so each device
advances its ensemble shard locally; objective reductions (mean/argmin over
the ensemble) compile to cross-device collectives.

This is the replacement for the reference's serial
per-parameter-set Python loop (``rrmpg/models/cemaneigegr4j.py:249``).
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import ENSEMBLE_AXIS, pad_to_multiple


def _pad_params(params, num, padded_num):
    """Pad leading-axis-(num,) leaves to padded_num by repeating entry 0."""
    if padded_num == num:
        return params
    pad = padded_num - num

    def pad_leaf(x):
        filler = jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])
        return jnp.concatenate([x, filler])

    return jax.tree.map(pad_leaf, params)


def ensemble_run(kernel, forcing_args, params, mesh,
                 axis_name=ENSEMBLE_AXIS, state=None):
    """Evaluate ``kernel`` over an ensemble, sharded across ``mesh``.

    Args:
        kernel: pure function ``kernel(*forcing_args, params_dict)`` for one
            parameter set (``kernel(*forcing_args, state, params_dict)``
            when ``state`` is given).
        forcing_args: tuple of shared (replicated) inputs.
        params: dict of (N,) parameter arrays.
        mesh: ``jax.sharding.Mesh`` with an ``axis_name`` axis.
        axis_name: mesh axis to shard the ensemble over.
        state: (optional) per-member state pytree (forecast mode); every
            leaf must carry a leading (N,) ensemble axis, sharded like the
            parameters.

    Returns:
        Tuple of outputs with leading ensemble axis (N, ...), padded shard
        removed -- including inside output pytrees (e.g. a final-state
        bundle).
    """
    num = jax.tree.leaves(params)[0].shape[0]
    n_shards = mesh.shape[axis_name]
    padded_num = pad_to_multiple(num, n_shards)
    params = _pad_params(params, num, padded_num)

    param_sharding = NamedSharding(mesh, P(axis_name))
    replicated = NamedSharding(mesh, P())
    params = jax.tree.map(
        lambda x: jax.device_put(x, param_sharding), params)
    forcing_args = tuple(
        jax.device_put(jnp.asarray(a), replicated) for a in forcing_args)

    n_forcing = len(forcing_args)
    if state is None:
        batched = _sharded_batched(kernel, n_forcing, with_state=False)
        outputs = batched(*forcing_args, params)
    else:
        state = _pad_params(state, num, padded_num)
        state = jax.tree.map(
            lambda x: jax.device_put(x, param_sharding), state)
        batched = _sharded_batched(kernel, n_forcing, with_state=True)
        outputs = batched(*forcing_args, state, params)
    if not isinstance(outputs, tuple):
        outputs = (outputs,)
    if padded_num != num:
        outputs = jax.tree.map(lambda x: x[:num], outputs)
    return outputs


@functools.lru_cache(maxsize=None)
def _sharded_batched(kernel, n_forcing, with_state=False):
    in_axes = (None,) * n_forcing + ((0, 0) if with_state else (0,))
    return jax.jit(jax.vmap(kernel, in_axes=in_axes))


def ensemble_objective(kernel, forcing_args, params, qobs, mesh,
                       metric=None, axis_name=ENSEMBLE_AXIS):
    """Sharded ensemble simulation + per-member objective + global best.

    Args:
        kernel: single-set kernel whose first output is qsim (T,).
        forcing_args: shared inputs.
        params: dict of (N,) parameter arrays.
        qobs: (T,) observations.
        mesh: device mesh.
        metric: callable (qobs, qsim_batch (N, T)) -> (N,) losses;
            defaults to MSE.

    Returns:
        (losses (N,), best_index, best_loss) -- losses gathered to host
        order; the argmin reduction runs as a cross-chip collective.
    """
    outputs = ensemble_run(kernel, forcing_args, params, mesh,
                           axis_name=axis_name)
    qsim = outputs[0]
    qobs = jnp.asarray(qobs, dtype=qsim.dtype)
    if metric is None:
        from ..utils.metrics import mse

        # NaN observations (missing-data gaps) are masked by the metric.
        losses = mse(qobs[None, :], qsim, axis=1)
    else:
        losses = metric(qobs, qsim)
    best_idx = jnp.argmin(losses)
    return losses, best_idx, losses[best_idx]
