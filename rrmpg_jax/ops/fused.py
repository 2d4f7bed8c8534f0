"""Fused ensemble time loop: one GPU program per block of members.

The ``xla`` engine runs a vmapped ``lax.scan``: a device while-loop of T
steps with at least one kernel launch per step, and (N, T) trajectories
written to device memory before they are scored.  The fused engine runs
the whole simulation inside one Pallas program per block of members,
compiled through Triton:

* the grid is ``(catchments, member blocks)``; programs are independent,
  so the card may run them in any order;
* the time loop is a ``lax.fori_loop`` inside the program, and every
  model state (stores, unit-hydrograph shift registers, snowpack layers,
  objective accumulators) is a loop value held in registers;
* forcing is read as one scalar per series and step from a ``(T, F)``
  block shared by the whole program and broadcast over its members;
* per-member values (parameters, initial states, pack-time reciprocals)
  are read once, before the loop, as ``(block,)`` vectors;
* an objective writes one float per member and observed series (or four
  sufficient statistics), a trajectory one ``(block,)`` row per step, and
  a final state one row per state variable after the loop.

A model enters as a :class:`FusedModel`: an ``init`` that reads the
member rows, a ``step`` that advances the carry by one timestep, and an
optional ``final`` that lists the state rows to write at the end.  The
GR4J, snow-family and HBV-Edu modules (``pallas_gr4j``, ``pallas_snow``,
``pallas_hbv``) define only those three functions and call :func:`run`.

On a CPU the same programs run with ``interpret=True`` (tests); the
Triton route has no other CPU mode.
"""

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Members per program.  One member per thread: the time loop is a serial
# dependency chain per member, so a program runs ``block // 32`` warps.
# On an H100 the widest program of a one-member-per-thread sweep (32..512
# members) was fastest for all three models, and four members per thread
# slowed the snow composition down 1.9x (PERF.md).
BLOCK = 512
MIN_BLOCK = 32


class FusedModel(NamedTuple):
    """A model in the form :func:`run` drives.

    Attributes:
        init: ``init(row) -> (consts, carry)``; ``row(name)`` loads that
            member row as a ``(block,)`` vector.  ``consts`` are
            loop-invariant values, ``carry`` the initial loop state.
        step: ``step(consts, carry, x, first) -> (carry, sims)``; ``x`` is
            the tuple of the F forcing scalars at this step, ``first`` the
            ``t == 0`` predicate, and ``sims`` a tuple of ``(block,)``
            simulated series values -- ``sims[0]`` is discharge, the
            trajectory output; ``sims[p]`` pairs with observed series p.
        final: ``final(consts, carry) -> tuple`` of ``(block,)`` state rows
            written after the loop (forecast mode), or None.
    """
    init: Callable
    step: Callable
    final: Optional[Callable] = None


def block_size(n, block=None):
    """Members per program for an ensemble of ``n`` members.

    An explicit ``block`` must be a power of two (Triton's block shapes
    are); by default small ensembles get the smallest power of two
    covering them (at least ``MIN_BLOCK``), large ones ``BLOCK``.
    """
    if block is None:
        covering = 1 << max(int(n) - 1, 0).bit_length()
        block = min(BLOCK, max(MIN_BLOCK, covering))
    if block < 1 or block & (block - 1):
        raise ValueError(
            f"block must be a positive power of two, got {block}.")
    return block


def _kernel(model, T, F, names, n_obs, stats, masked, traj, n_final,
            x_ref, rows_ref, *refs):
    refs = list(refs)
    obs_ref = refs.pop(0) if n_obs else None
    out_refs = refs
    index = {name: k for k, name in enumerate(names)}
    consts, carry = model.init(lambda name: rows_ref[index[name], :])

    zero = jnp.zeros_like(rows_ref[0, :])
    n_terms = 4 if stats else 1
    accs = (zero,) * (n_obs * n_terms)

    def body(t, state):
        carry, accs = state
        x = tuple(x_ref[t, k] for k in range(F))
        carry, sims = model.step(consts, carry, x, t == 0)
        if traj:
            out_refs[1 if n_obs else 0][t, :] = sims[0]
        accs = list(accs)
        for p in range(n_obs):
            sim = sims[p]
            qo = obs_ref[t, p]
            if masked:
                # NaN observations are missing-data gaps: zero them before
                # the products and drop the step from this series' sums.
                valid = qo == qo
                qo = jnp.where(valid, qo, 0.0)
            d = sim - qo
            terms = (d * d, sim, sim * sim, sim * qo)[:n_terms]
            for j, term in enumerate(terms):
                if masked:
                    term = jnp.where(valid, term, 0.0)
                accs[p * n_terms + j] = accs[p * n_terms + j] + term
        return carry, tuple(accs)

    carry, accs = lax.fori_loop(0, T, body, (carry, accs))
    if n_obs:
        for k, acc in enumerate(accs):
            out_refs[0][k, :] = acc
    if n_final:
        for k, row in enumerate(model.final(consts, carry)):
            out_refs[-1][k, :] = row


def run(model, forcing, rows, *, obs=None, stats=False, masked=False,
        traj=False, n_final=0, block=None, interpret=False,
        name="fused_ensemble"):
    """Run a fused ensemble simulation.

    Args:
        model: the :class:`FusedModel`.
        forcing: ``(C, T, F)`` forcing, one ``(T, F)`` table per catchment.
        rows: dict of per-member rows, each a scalar or ``(N,)`` (shared
            by every catchment) or ``(C, N)``/``(C, 1)`` (per catchment).
            Padded members get 1.0.
        obs: optional ``(C, T, P)`` observed series; series p is scored
            against ``sims[p]``.
        stats: accumulate ``[mse, mean(q), mean(q^2), mean(q*obs)]`` per
            observed series instead of the mse alone.
        masked: (compile-time) treat NaN observations as gaps: each
            series' means are taken over its own valid steps.
        traj: also return the discharge trajectory.
        n_final: number of state rows ``model.final`` returns.
        block: members per program (:func:`block_size`); the program
            runs one member per thread.
        interpret: run the program in the Pallas interpreter (CPU).

    Returns:
        Tuple, in this order, of what was asked for: the objective
        ``(C, P or 4P, N)`` (time means), the trajectory ``(C, T, N)``,
        the final state ``(C, n_final, N)``.
    """
    forcing = jnp.asarray(forcing)
    dtype = forcing.dtype
    C, T, F = forcing.shape
    names = tuple(rows)
    n = max(jnp.shape(v)[-1] for v in rows.values() if jnp.ndim(v))
    per_catchment = any(jnp.ndim(v) == 2 for v in rows.values())
    shape = (C, n) if per_catchment else (1, n)
    stacked = jnp.stack([jnp.broadcast_to(jnp.asarray(rows[k], dtype), shape)
                         for k in names], axis=1)        # (C or 1, R, N)
    B = block_size(n, block)
    n_pad = -(-n // B) * B
    stacked = jnp.pad(stacked, ((0, 0), (0, 0), (0, n_pad - n)),
                      constant_values=1.0)
    R = stacked.shape[1]

    in_specs = [
        pl.BlockSpec((None, T, F), lambda c, i: (c, 0, 0)),
        pl.BlockSpec((None, R, B),
                     (lambda c, i: (c, 0, i)) if per_catchment
                     else (lambda c, i: (0, 0, i))),
    ]
    inputs = [forcing, stacked]
    out_specs, out_shape = [], []
    n_obs = 0
    if obs is not None:
        obs = jnp.asarray(obs, dtype)
        n_obs = obs.shape[-1]
        K = n_obs * (4 if stats else 1)
        in_specs.append(pl.BlockSpec((None, T, n_obs),
                                     lambda c, i: (c, 0, 0)))
        inputs.append(obs)
        out_specs.append(pl.BlockSpec((None, K, B), lambda c, i: (c, 0, i)))
        out_shape.append(jax.ShapeDtypeStruct((C, K, n_pad), dtype))
    if traj:
        out_specs.append(pl.BlockSpec((None, T, B), lambda c, i: (c, 0, i)))
        out_shape.append(jax.ShapeDtypeStruct((C, T, n_pad), dtype))
    if n_final:
        out_specs.append(pl.BlockSpec((None, n_final, B),
                                      lambda c, i: (c, 0, i)))
        out_shape.append(jax.ShapeDtypeStruct((C, n_final, n_pad), dtype))

    kernel = functools.partial(_kernel, model, T, F, names, n_obs, stats,
                               masked, traj, n_final)
    outs = pl.pallas_call(
        kernel,
        grid=(C, n_pad // B),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        compiler_params=pl_triton.CompilerParams(
            num_warps=min(max(B // 32, 1), 32),
            num_stages=1),
        interpret=interpret,
        name=name,
    )(*inputs)
    outs = [o[..., :n] for o in outs]
    if n_obs:
        if masked:
            counts = jnp.sum(jnp.isfinite(obs), axis=1)        # (C, P)
            if stats:
                counts = jnp.repeat(counts, 4, axis=1)
            outs[0] = outs[0] / counts[:, :, None]
        else:
            outs[0] = outs[0] / T
    return tuple(outs)
