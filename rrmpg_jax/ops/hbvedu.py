"""HBV educational model kernel (Aghakouchak & Habib 2010).

Reference: ``rrmpg/models/hbvedu_model.py:15-129`` -- a sequential loop over
four storages (snow, soil, near-surface s1, base-flow s2) with degree-day
snow accounting and a reservoir cascade.

Design notes: the monthly climatology lookups ``PE_m[month[t]]`` /
``T_m[month[t]]`` are hoisted out of the recurrence as a batched gather, so
the scan body is pure branch-free elementwise arithmetic (`jnp.where` in
place of data-dependent branches) with a four-float carry.
"""

import jax.numpy as jnp
from jax import lax


def _make_step(params):
    """Build the per-timestep HBV state update (shared by the cold-start
    and warm-continuation entry points)."""
    T_t = params['T_t']
    DD = params['DD']
    FC = params['FC']
    Beta = params['Beta']
    C = params['C']
    PWP = params['PWP']
    K_0 = params['K_0']
    K_1 = params['K_1']
    K_2 = params['K_2']
    K_p = params['K_p']
    L = params['L']

    def step(carry, x):
        snow_prev, soil_prev, s1_prev, s2_prev = carry
        temp_t, prec_t, pe_month_t, t_month_t = x

        freezing = temp_t < T_t
        melt_pot = DD * (temp_t - T_t)
        snow_t = jnp.where(freezing,
                           snow_prev + prec_t,
                           jnp.maximum(0.0, snow_prev - melt_pot))
        liquid_water = jnp.where(freezing,
                                 0.0,
                                 prec_t + jnp.minimum(snow_prev, melt_pot))

        prec_eff = liquid_water * (soil_prev / FC) ** Beta

        pe = (1.0 + C * (temp_t - t_month_t)) * pe_month_t
        ea = jnp.where(soil_prev > PWP, pe, pe * (soil_prev / PWP))

        soil_t = soil_prev + liquid_water - prec_eff - ea

        overflow = jnp.maximum(0.0, s1_prev - L) * K_0
        s1_t = s1_prev + prec_eff - overflow - s1_prev * K_1 - s1_prev * K_p
        s2_t = s2_prev + s1_prev * K_p - s2_prev * K_2

        qsim_t = overflow + s1_t * K_1 + s2_t * K_2
        new_carry = (snow_t, soil_t, s1_t, s2_t)
        return new_carry, (qsim_t, snow_t, soil_t, s1_t, s2_t)

    return step


def run_hbvedu(temp, prec, month, pe_m, t_m, snow_init, soil_init, s1_init,
               s2_init, params, *, unroll: int = 8,
               return_final: bool = False):
    """Simulate the HBV-Edu model for a single parameter set.

    Args:
        temp: (T,) daily mean temperature.
        prec: (T,) daily precipitation.
        month: (T,) integer month index of each timestep, 0-based (0..11).
        pe_m: (12,) long-term monthly potential evapotranspiration.
        t_m: (12,) long-term monthly mean temperature.
        snow_init, soil_init, s1_init, s2_init: scalar initial storages.
        params: dict with scalar entries T_t, DD, FC, Beta, C, PWP, K_0,
            K_1, K_2, K_p, L.
        return_final: also return the final ``(snow, soil, s1, s2)`` carry,
            suitable for :func:`run_hbvedu_warm` continuation.

    Returns:
        (qsim, snow, soil, s1, s2): five (T,) arrays; index 0 holds the
        initial storages and qsim[0] = 0 (reference loop starts at t=1).
        With ``return_final`` additionally the final storage tuple.
    """
    temp = jnp.asarray(temp)
    prec = jnp.asarray(prec)
    dtype = jnp.result_type(temp, prec)
    temp = temp.astype(dtype)
    prec = prec.astype(dtype)
    pe_m = jnp.asarray(pe_m, dtype=dtype)
    t_m = jnp.asarray(t_m, dtype=dtype)
    month = jnp.asarray(month)

    # Hoist the climatology gathers out of the scan.
    pe_month = pe_m[month]
    t_month = t_m[month]

    step = _make_step(params)
    init = tuple(jnp.asarray(v, dtype=dtype)
                 for v in (snow_init, soil_init, s1_init, s2_init))
    xs = (temp[1:], prec[1:], pe_month[1:], t_month[1:])
    final, (qsim, snow, soil, s1, s2) = lax.scan(step, init, xs,
                                                 unroll=unroll)

    def prepend(x0, series):
        return jnp.concatenate([jnp.asarray(x0, dtype=dtype)[None], series])

    qsim = prepend(0.0, qsim)
    snow = prepend(snow_init, snow)
    soil = prepend(soil_init, soil)
    s1 = prepend(s1_init, s1)
    s2 = prepend(s2_init, s2)
    if return_final:
        # Degenerate single-step series never enter the scan; the final
        # carry is then the initial storages themselves.
        if temp.shape[0] == 1:
            final = init
        return qsim, snow, soil, s1, s2, final
    return qsim, snow, soil, s1, s2


def run_hbvedu_warm(temp, prec, month, pe_m, t_m, state, params, *,
                    unroll: int = 8):
    """Continue an HBV-Edu simulation from carried storages.

    Forecast/continuation mode: unlike :func:`run_hbvedu` (which follows
    the reference in treating index 0 as the initialization step with
    ``qsim[0] = 0``), every timestep here advances the model from
    ``state`` -- so splitting a series and chaining segments through the
    returned final state reproduces the unbroken trajectory exactly.

    Args:
        temp, prec, month: (T,) continuation-segment forcing.
        pe_m, t_m: (12,) monthly climatologies.
        state: tuple ``(snow, soil, s1, s2)`` of carried storages (e.g. a
            previous segment's final state).
        params: dict with the 11 HBV parameter scalars.

    Returns:
        (qsim, snow, soil, s1, s2, final_state) where the series are (T,)
        and ``final_state`` is the ``(snow, soil, s1, s2)`` tuple after
        the last step.
    """
    temp = jnp.asarray(temp)
    prec = jnp.asarray(prec)
    dtype = jnp.result_type(temp, prec)
    pe_month = jnp.asarray(pe_m, dtype)[jnp.asarray(month)]
    t_month = jnp.asarray(t_m, dtype)[jnp.asarray(month)]

    step = _make_step(params)
    init = tuple(jnp.asarray(v, dtype=dtype) for v in state)
    xs = (temp.astype(dtype), prec.astype(dtype), pe_month, t_month)
    final, (qsim, snow, soil, s1, s2) = lax.scan(step, init, xs,
                                                 unroll=unroll)
    return qsim, snow, soil, s1, s2, final
