"""Fused GR4J ensemble kernels (Pallas, Triton route).

The whole GR4J time loop for a block of members runs inside one GPU
program (:mod:`rrmpg_jax.ops.fused`): the production and routing stores
and both unit-hydrograph shift registers are loop values in registers,
the UH ordinates are computed once per member before the loop (padded to
the static register lengths, ``ceil(x4) <= 10`` / ``ceil(2*x4+1) <= 21``,
the same masking-free padding as ``ops/uh.py``), and
``gr4j_ensemble_mse_pallas`` folds the objective into the loop so that one
float per member (or four sufficient statistics) leaves the program --
the Monte-Carlo / calibration production path.

Step math follows the reference loop (``rrmpg/models/gr4j_model.py:86-154``);
integer powers are expanded to multiply/sqrt chains and the divisions by
the store capacities are multiplies by pack-time reciprocals.
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from . import fused
from .fused import BLOCK  # noqa: F401  (default members per program)
from .uh import NUM_UH1, NUM_UH2


def _pow4(x):
    x2 = x * x
    return x2 * x2


def _sh1(j, x4):
    """SH1 S-curve at integer time ``j >= 0`` (``ops/uh.py:s_curve1``)."""
    if j == 0:
        return 0.0
    return jnp.clip(j / x4, 0.0, 1.0) ** 2.5


def _sh2(j, x4):
    """SH2 S-curve at integer time ``j >= 0`` (``ops/uh.py:s_curve2``)."""
    if j == 0:
        return 0.0
    ratio = j / x4
    rising = 0.5 * jnp.clip(ratio, 0.0, 1.0) ** 2.5
    falling = 1.0 - 0.5 * jnp.clip(2.0 - ratio, 0.0, 1.0) ** 2.5
    return jnp.where(j <= x4, rising, falling)


def gr4j_rows(params, s_init, r_init, dtype, state=None, h=0):
    """Per-member rows of the GR4J kernels.

    ``1/x1`` and ``1/x3`` ride in as rows so the per-step divisions by
    the store capacities become multiplies.  With ``state`` (a batched
    :class:`~rrmpg_jax.ops.gr4j.GR4JState`), the stores enter at the
    carried absolute levels and the last ``h`` routing inputs become the
    ``hist*`` rows the UH registers are rebuilt from.
    """
    x1 = jnp.asarray(params['x1'], dtype)
    x3 = jnp.asarray(params['x3'], dtype)
    rows = {'x1': x1, 'x2': jnp.asarray(params['x2'], dtype),
            'x4': jnp.asarray(params['x4'], dtype),
            'ix1': 1.0 / x1, 'ix3': 1.0 / x3}
    if state is None:
        rows['s0'] = s_init * x1
        rows['r0'] = r_init * x3
    else:
        rows['s0'] = jnp.asarray(state.s, dtype)
        rows['r0'] = jnp.asarray(state.r, dtype)
        hist = jnp.asarray(state.pr_history, dtype)
        width = hist.shape[-1]
        for j in range(h):
            rows[f'hist{j}'] = hist[:, width - h + j]
    return rows


def gr4j_init(row, num_uh1, num_uh2, warm=False):
    """(consts, carry) of one member block before the first step.

    With ``warm``, the UH shift registers are rebuilt from the ``hist*``
    rows (the last ``H = num_uh2 - 1`` routing inputs, oldest first) to
    the exact state an unbroken run would carry: ``uh[j] = sum_m
    oh[j+m] * pr_{t-1-m}``, the triangular contraction that bit-matches the
    XLA warm path's FIR over ``[history | segment]``
    (``ops/gr4j.py:run_gr4j_warm``).
    """
    x4 = row('x4')
    oh1 = tuple(_sh1(j + 1, x4) - _sh1(j, x4) for j in range(num_uh1))
    oh2 = tuple(_sh2(j + 1, x4) - _sh2(j, x4) for j in range(num_uh2))
    h = num_uh2 - 1 if warm else 0
    hist = [row(f'hist{j}') for j in range(h)]
    zero = jnp.zeros_like(x4)

    def registers(oh, share):
        regs = []
        for j in range(len(oh)):
            acc = zero
            for m in range(min(h, len(oh) - j)):
                acc = acc + oh[j + m] * (share * hist[h - 1 - m])
            regs.append(acc)
        return tuple(regs)

    consts = (row('x1'), row('x2'), row('ix1'), row('ix3'), oh1, oh2)
    carry = (row('s0'), row('r0'), registers(oh1, 0.9),
             registers(oh2, 0.1))
    return consts, carry


def gr4j_step(consts, carry, p, e):
    """One GR4J timestep; returns (carry, q, p_r).

    The rain/evaporation branch needs no ``where``: the inactive arm is
    exactly zero because ``p_n``/``pe_n`` is exactly zero there, so
    ``tanh(0) = 0`` kills its numerator while the denominator stays 1.
    """
    x1, x2, ix1, ix3, oh1, oh2 = consts
    s, r, uh1, uh2 = carry

    # --- production store (eq. 3/4 + percolation) ---
    p_n = jnp.maximum(p - e, 0.0)
    pe_n = jnp.maximum(e - p, 0.0)
    sr = s * ix1
    tanh_pn = jnp.tanh(p_n * ix1)
    tanh_pen = jnp.tanh(pe_n * ix1)
    p_s = (x1 * (1.0 - sr * sr) * tanh_pn) / (1.0 + sr * tanh_pn)
    e_s = (s * (2.0 - sr) * tanh_pen) / (1.0 + (1.0 - sr) * tanh_pen)
    s_interim = s - e_s + p_s
    z = _pow4(s_interim * ix1 * (4.0 / 9.0))
    perc = s_interim * (1.0 - lax.rsqrt(jnp.sqrt(1.0 + z)))
    s = s_interim - perc
    p_r = perc + (p_n - p_s)

    # --- unit hydrograph shift registers ---
    pr1 = 0.9 * p_r
    pr2 = 0.1 * p_r
    uh1 = tuple(uh1[j + 1] + oh1[j] * pr1 for j in range(len(oh1) - 1)) \
        + (oh1[-1] * pr1,)
    uh2 = tuple(uh2[j + 1] + oh2[j] * pr2 for j in range(len(oh2) - 1)) \
        + (oh2[-1] * pr2,)

    # --- routing store (eq. 18 + non-linear outflow) ---
    rx = r * ix3
    rx2 = rx * rx
    gw_exchange = x2 * (rx2 * rx * jnp.sqrt(rx))       # (r/x3)^3.5
    r_interim = jnp.maximum(0.0, r + uh1[0] + gw_exchange)
    z = _pow4(r_interim * ix3)
    q_r = r_interim * (1.0 - lax.rsqrt(jnp.sqrt(1.0 + z)))
    r = r_interim - q_r
    q_d = jnp.maximum(0.0, uh2[0] + gw_exchange)
    return (s, r, uh1, uh2), q_r + q_d, p_r


def push_history(hist, p_r):
    """Shift the last-``H`` routing-input window by one step."""
    return (hist + (p_r,))[1:] if hist else ()


def _model(num_uh1, num_uh2, warm=False, final=False):
    """GR4J as a :class:`~rrmpg_jax.ops.fused.FusedModel` (forcing
    ``(prec, etp)``); with ``final`` the carry also tracks the routing-input
    history so the end state can be written."""
    h = num_uh2 - 1

    def init(row):
        consts, carry = gr4j_init(row, num_uh1, num_uh2, warm)
        if final:
            zero = jnp.zeros_like(carry[0])
            hist = tuple(row(f'hist{j}') if warm else zero
                         for j in range(h))
            carry = (carry, hist)
        return consts, carry

    def step(consts, carry, x, first):
        p, e = x
        if final:
            carry, hist = carry
        carry, q, p_r = gr4j_step(consts, carry, p, e)
        if final:
            carry = (carry, push_history(hist, p_r))
        return carry, (q,)

    def fin(consts, carry):
        (s, r, _, _), hist = carry
        return (s, r) + hist

    return fused.FusedModel(init, step, fin if final else None)


def _forcing(*series):
    """Stack (T,) or (C, T) series into the (C, T, F) forcing table of
    :func:`rrmpg_jax.ops.fused.run`."""
    out = jnp.stack(series, axis=-1)
    return out if out.ndim == 3 else out[None]


@functools.partial(jax.jit, static_argnames=("num_uh1", "num_uh2", "block",
                                              "interpret"))
def gr4j_simulate_pallas(prec, etp, s_init, r_init, params,
                         num_uh1=NUM_UH1, num_uh2=NUM_UH2, block=None,
                         interpret=False):
    """Fused-ensemble GR4J simulation; returns qsim with shape (N, T).

    Args:
        prec, etp: (T,) forcing series.
        s_init, r_init: scalar store initializations (fractions of x1/x3).
        params: dict of (N,) arrays x1..x4.
        num_uh1, num_uh2: static UH register lengths; must cover
            ceil(x4) / ceil(2*x4+1) for every member (10/21 covers the
            widest published bounds; 3/7 suffices for plain-GR4J bounds
            x4 <= 2.9).
        block: members per program (:mod:`rrmpg_jax.ops.fused`).
        interpret: run in the Pallas interpreter (CPU testing).
    """
    dtype = jnp.asarray(prec).dtype
    rows = gr4j_rows(params, jnp.asarray(s_init, dtype),
                     jnp.asarray(r_init, dtype), dtype)
    (qsim,) = fused.run(_model(num_uh1, num_uh2),
                        _forcing(jnp.asarray(prec, dtype),
                                 jnp.asarray(etp, dtype)),
                        rows, traj=True, block=block,
                        interpret=interpret, name="gr4j_traj")
    return qsim[0].T


@functools.partial(jax.jit, static_argnames=("num_uh1", "num_uh2", "block",
                                              "interpret",
                                              "warm"))
def gr4j_simulate_pallas_state(prec, etp, params, state=None, s_init=0.0,
                               r_init=0.0, num_uh1=NUM_UH1,
                               num_uh2=NUM_UH2, block=None,
                               interpret=False, warm=None):
    """Forecast-mode fused GR4J: returns (qsim (N, T), final GR4JState).

    The fused counterpart of ``run_gr4j(return_final=True)`` /
    ``run_gr4j_warm`` (``ops/gr4j.py``): the ensemble state (stores + UH
    registers) enters from a carried
    :class:`~rrmpg_jax.ops.gr4j.GR4JState` (``state=``, every leaf
    batched over members, ``pr_history`` trimmed to the last
    ``num_uh2 - 1`` inputs) and leaves as ``2 + H`` rows per member.
    Split-invariant against the XLA warm path.

    Args:
        state: (optional) batched GR4JState; cold fractional
            ``s_init``/``r_init`` start if omitted.
        warm: static override of ``state is not None`` (internal; lets
            jit re-tracing key on the static fact, not the pytree).
    """
    from .gr4j import GR4JState

    dtype = jnp.asarray(prec).dtype
    h = num_uh2 - 1
    if warm is None:
        warm = state is not None
    rows = gr4j_rows(params, jnp.asarray(s_init, dtype),
                     jnp.asarray(r_init, dtype), dtype,
                     state=state if warm else None, h=h)
    qsim, fs = fused.run(_model(num_uh1, num_uh2, warm=warm, final=True),
                         _forcing(jnp.asarray(prec, dtype),
                                  jnp.asarray(etp, dtype)),
                         rows, traj=True, n_final=2 + h, block=block,
                         interpret=interpret, name="gr4j_traj_state")
    fs = fs[0]
    return qsim[0].T, GR4JState(s=fs[0], r=fs[1], pr_history=fs[2:].T)


@functools.partial(jax.jit, static_argnames=("num_uh1", "num_uh2", "block",
                                              "interpret",
                                              "stats", "warm", "masked"))
def gr4j_ensemble_mse_pallas(prec, etp, qobs, s_init, r_init, params,
                             num_uh1=NUM_UH1, num_uh2=NUM_UH2, block=None,
                             interpret=False, stats=False,
                             state=None, warm=None, masked=False):
    """Fused GR4J simulate + MSE objective; returns (N,) losses.

    The Monte-Carlo / calibration hot path: the squared error accumulates
    in registers and only one float per member reaches device memory.

    With ``stats=True``, returns a (4, N) array of time-mean sufficient
    statistics [mse, mean_q, mean_q^2, mean_q*qobs] instead -- enough
    for NSE/KGE/correlation objectives via
    :func:`rrmpg_jax.ops.pallas_snow.losses_from_stats`.

    With ``state`` (a batched :class:`~rrmpg_jax.ops.gr4j.GR4JState`,
    every leaf carrying the member axis), the objective evaluates a WARM
    continuation -- stores enter at the carried absolute levels and the
    UH registers rebuild from the routing-input history, exactly as in
    :func:`gr4j_simulate_pallas_state` -- the fused path for operational
    recalibration on recent data (``fit(initial_state=,
    engine='pallas')``).  ``warm`` statically overrides
    ``state is not None`` for jit re-trace keying.

    ``masked=True`` (compile-time) treats NaN observations as missing
    data: gap steps are excluded from the accumulations and the result
    normalizes over the valid count (callers detect gaps host-side so
    the gap-free specialization pays nothing).
    """
    dtype = jnp.asarray(prec).dtype
    if warm is None:
        warm = state is not None
    rows = gr4j_rows(params, jnp.asarray(s_init, dtype),
                     jnp.asarray(r_init, dtype), dtype,
                     state=state if warm else None, h=num_uh2 - 1)
    (out,) = fused.run(_model(num_uh1, num_uh2, warm=warm),
                       _forcing(jnp.asarray(prec, dtype),
                                jnp.asarray(etp, dtype)),
                       rows, obs=jnp.asarray(qobs, dtype)[None, :, None],
                       stats=stats, masked=masked, block=block,
                       interpret=interpret, name="gr4j_objective")
    return out[0] if stats else out[0, 0]


@functools.partial(jax.jit, static_argnames=("num_uh1", "num_uh2", "block",
                                              "interpret",
                                              "masked", "stats"))
def gr4j_regional_mse_pallas(prec, etp, qobs, s_init, r_init, params,
                             num_uh1=NUM_UH1, num_uh2=NUM_UH2, block=None,
                             interpret=False, masked=False,
                             stats=False):
    """Fused regional GR4J MC objective; returns (C, N) losses.

    The (catchment x member) cross product in one launch: the grid's
    first axis walks the catchments, so one float per (catchment, member)
    leaves the card.

    Args:
        prec, etp, qobs: (C, T) per-catchment series.
        s_init, r_init: scalar store initializations (fractions of x1/x3).
        params: dict of (N,) arrays x1..x4, shared across catchments.
        masked: (compile-time) exclude NaN observations -- the masked
            loss normalizes per catchment over its own valid count, so
            ragged discharge records (NaN-padded to rectangular) and
            in-record gaps calibrate correctly.
        stats: return (4, C, N) time-mean sufficient statistics
            [mse, mean_q, mean_q^2, mean_q*qobs] instead of MSE --
            enough for per-catchment NSE/KGE/correlation objectives
            (``pallas_snow.losses_from_stats`` per catchment).
    """
    dtype = jnp.asarray(prec).dtype
    rows = gr4j_rows(params, jnp.asarray(s_init, dtype),
                     jnp.asarray(r_init, dtype), dtype)
    (out,) = fused.run(_model(num_uh1, num_uh2),
                       _forcing(jnp.asarray(prec, dtype),
                                jnp.asarray(etp, dtype)),
                       rows, obs=jnp.asarray(qobs, dtype)[..., None],
                       stats=stats, masked=masked, block=block,
                       interpret=interpret, name="gr4j_regional_objective")
    if stats:
        return out.transpose(1, 0, 2)                  # (4, C, N)
    return out[:, 0]
