"""Fused HBV-Edu ensemble kernels (Pallas, Triton route).

Same architecture as :mod:`rrmpg_jax.ops.pallas_gr4j`: the full HBV time
loop for a block of members runs inside one GPU program
(:mod:`rrmpg_jax.ops.fused`) with the four storages (snow, soil,
near-surface, base-flow) as loop values in registers, the month-gathered
climatologies read as one scalar per step, and the squared error
accumulated in the loop -- one float per member leaves the program.

Step math follows the reference loop exactly
(``rrmpg/models/hbvedu_model.py:86-127``), including its unclamped soil
store (a negative soil level yields NaN through the Beta power, exactly as
the reference's ``np.power`` does -- the DE optimizer rejects such
candidates).
"""

import functools

import jax
import jax.numpy as jnp

from . import fused

_PARAMS = ('T_t', 'DD', 'FC', 'Beta', 'C', 'PWP', 'K_0', 'K_1', 'K_2',
           'K_p', 'L')
_STORES = ('snow0', 'soil0', 's10', 's20')


def _model(warm=False, final=False):
    """HBV-Edu as a :class:`~rrmpg_jax.ops.fused.FusedModel` (forcing
    ``(temp, prec, pe_month, t_month)``).

    ``warm`` (compile-time) drops the reference's t=0 init step (stores
    frozen, q=0, ``hbvedu_model.py:84-86``): a warm continuation advances
    the carried storages at every timestep, exactly like
    :func:`rrmpg_jax.ops.hbvedu.run_hbvedu_warm`.
    """

    def init(row):
        consts = tuple(row(k) for k in _PARAMS + ('iFC', 'iPWP'))
        return consts, tuple(row(k) for k in _STORES)

    def step(consts, carry, x, first):
        (T_t, DD, _FC, Beta, C, PWP, K_0, K_1, K_2, K_p, L, iFC,
         iPWP) = consts
        snow_prev, soil_prev, s1_prev, s2_prev = carry
        temp_t, prec_t, pe_month, t_month = x

        freezing = temp_t < T_t
        melt_pot = DD * (temp_t - T_t)
        snow = jnp.where(freezing, snow_prev + prec_t,
                         jnp.maximum(0.0, snow_prev - melt_pot))
        liquid = jnp.where(freezing, 0.0,
                           prec_t + jnp.minimum(snow_prev, melt_pot))

        prec_eff = liquid * (soil_prev * iFC) ** Beta
        pe = (1.0 + C * (temp_t - t_month)) * pe_month
        ea = jnp.where(soil_prev > PWP, pe, pe * (soil_prev * iPWP))
        soil = soil_prev + liquid - prec_eff - ea

        overflow = jnp.maximum(0.0, s1_prev - L) * K_0
        s1 = s1_prev + prec_eff - overflow - s1_prev * K_1 - s1_prev * K_p
        s2 = s2_prev + s1_prev * K_p - s2_prev * K_2
        q = overflow + s1 * K_1 + s2 * K_2
        new = (snow, soil, s1, s2)
        if warm:
            return new, (q,)
        return (tuple(jnp.where(first, o, v) for o, v in zip(carry, new)),
                (jnp.where(first, 0.0, q),))

    return fused.FusedModel(init, step,
                            (lambda consts, carry: carry) if final else None)


def _prepare(temp, prec, month, pe_m, t_m, inits, params):
    """Forcing table (1, T, 4) and per-member rows."""
    dtype = jnp.asarray(prec).dtype
    month = jnp.asarray(month)
    forcing = jnp.stack([jnp.asarray(temp, dtype), jnp.asarray(prec, dtype),
                         jnp.asarray(pe_m, dtype)[month],
                         jnp.asarray(t_m, dtype)[month]], axis=-1)[None]
    rows = {k: jnp.asarray(params[k], dtype) for k in _PARAMS}
    rows.update({k: jnp.asarray(v, dtype) for k, v in zip(_STORES, inits)})
    rows['iFC'] = 1.0 / rows['FC']
    rows['iPWP'] = 1.0 / rows['PWP']
    return forcing, rows, dtype


@functools.partial(jax.jit, static_argnames=("block",
                                              "interpret", "stats",
                                              "masked", "warm"))
def hbv_ensemble_mse_pallas(temp, prec, month, pe_m, t_m, qobs, snow_init,
                            soil_init, s1_init, s2_init, params,
                            block=None, interpret=False,
                            stats=False, masked=False, state=None,
                            warm=None):
    """Fused HBV-Edu ensemble MSE; returns (N,) losses.

    Args:
        temp, prec: (T,) forcing series.
        month: (T,) 0-based month indices.
        pe_m, t_m: (12,) monthly climatologies (gathered host-side).
        qobs: (T,) observations.
        snow_init, soil_init, s1_init, s2_init: scalar initial storages.
        params: dict of (N,) arrays for the 11 HBV parameters.
        stats: return the (4, N) time-mean sufficient statistics
            [mse, mean_q, mean_q^2, mean_q*qobs] instead (for NSE/KGE
            objectives via ``pallas_snow.losses_from_stats``).
        masked: (compile-time) treat NaN observations as missing-data
            gaps, excluded from the accumulations and the normalization.
        state: (optional) batched
            :class:`~rrmpg_jax.models.states.HBVEduState` -- the
            objective evaluates a WARM continuation from the carried
            storages (no reference t=0 init step), the fused path for
            ``fit(initial_state=, engine='pallas')``.  ``warm``
            statically overrides ``state is not None``.
        block: members per program (:mod:`rrmpg_jax.ops.fused`).
    """
    if warm is None:
        warm = state is not None
    inits = ((state.snow, state.soil, state.s1, state.s2) if warm
             else (snow_init, soil_init, s1_init, s2_init))
    forcing, rows, dtype = _prepare(temp, prec, month, pe_m, t_m, inits,
                                    params)
    (out,) = fused.run(_model(warm=warm), forcing, rows,
                       obs=jnp.asarray(qobs, dtype)[None, :, None],
                       stats=stats, masked=masked, block=block,
                       interpret=interpret, name="hbv_objective")
    return out[0] if stats else out[0, 0]


@functools.partial(jax.jit, static_argnames=("block",
                                              "interpret"))
def hbv_simulate_pallas(temp, prec, month, pe_m, t_m, snow_init,
                        soil_init, s1_init, s2_init, params, block=None,
                        interpret=False):
    """Fused-ensemble HBV-Edu simulation; returns qsim with shape (N, T).

    Trajectory mode of :func:`hbv_ensemble_mse_pallas`: the same fused time
    loop, but the discharge series is written out per timestep instead of
    being reduced to a loss.
    """
    forcing, rows, _ = _prepare(temp, prec, month, pe_m, t_m,
                                (snow_init, soil_init, s1_init, s2_init),
                                params)
    (qsim,) = fused.run(_model(), forcing, rows, traj=True, block=block,
                        interpret=interpret, name="hbv_traj")
    return qsim[0].T


@functools.partial(jax.jit, static_argnames=("block",
                                              "interpret", "warm"))
def hbv_simulate_pallas_state(temp, prec, month, pe_m, t_m, snow_init,
                              soil_init, s1_init, s2_init, params,
                              block=None, interpret=False,
                              state=None, warm=None):
    """Fused HBV-Edu simulation with state entry/exit (forecast mode).

    Like :func:`hbv_simulate_pallas` but additionally returns the
    end-of-series storages, and -- with ``state`` (a batched
    :class:`~rrmpg_jax.models.states.HBVEduState`, every leaf carrying
    the member axis) -- evaluates a WARM continuation: the storages
    enter at the carried levels and every timestep advances them (no
    reference t=0 init step), matching
    :func:`rrmpg_jax.ops.hbvedu.run_hbvedu_warm` exactly.  ``warm``
    statically overrides ``state is not None`` for jit re-trace keying.

    Returns:
        ``(qsim (N, T), HBVEduState)`` with the member axis leading.
    """
    from ..models.states import HBVEduState

    if warm is None:
        warm = state is not None
    inits = ((state.snow, state.soil, state.s1, state.s2) if warm
             else (snow_init, soil_init, s1_init, s2_init))
    forcing, rows, _ = _prepare(temp, prec, month, pe_m, t_m, inits,
                                params)
    qsim, fs = fused.run(_model(warm=warm, final=True), forcing, rows,
                         traj=True, n_final=4, block=block,
                         interpret=interpret, name="hbv_traj_state")
    fs = fs[0]
    return qsim[0].T, HBVEduState(snow=fs[0], soil=fs[1], s1=fs[2],
                                  s2=fs[3])
