"""Cemaneige snow-accounting kernels (Valery 2010), with the SWE-SCA linear
hysteresis extension (Riboust et al. 2019) and a degree-day ice-melt routine
(Nepal et al. 2017).

Reference loops: ``rrmpg/models/cemaneige_model.py:15-127``,
``rrmpg/models/cemaneigehyst_model.py:4-166``,
``rrmpg/models/icemelt_model.py:15-65``.

Design: the reference iterates elevation layers in an (effectively
serial) outer ``prange`` with an inner sequential time loop.  Here the layer
axis is simply a vector axis *inside* the scan carry -- each scan step
updates all layers (and, under vmap, all ensemble members) as one wide
elementwise block.  The data-dependent series constant (the snow-cover
threshold from the mean annual solid precipitation,
``cemaneige_model.py:80``) is hoisted out of the recurrence as a single
batched reduction.

Timestep 0 is special-cased in the reference (stores are *initialized*
rather than updated, ``cemaneige_model.py:85-96``); a per-step boolean
"first" input keeps the scan body uniform while reproducing that behavior
exactly.
"""

import jax.numpy as jnp
from jax import lax

MELT_TEMP = 0.0
MIN_MELT_SHARE = 0.1
SNOW_SHIELD_THRESHOLD = 1.0  # mm SWE above which snow shields ice from melt


def _split_precipitation(prec, frac_solid_prec):
    snow = prec * frac_solid_prec
    rain = prec - snow
    return snow, rain


def _thermal_and_potential_melt(eTG_prev, temp_t, G, CTG, Kf, first,
                                thermal_state_init):
    """Shared snowpack thermal-state / potential-melt update."""
    eTG = jnp.where(first, thermal_state_init,
                    CTG * eTG_prev + (1.0 - CTG) * temp_t)
    eTG = jnp.minimum(eTG, 0.0)
    melting = (eTG == 0.0) & (temp_t > MELT_TEMP)
    pot_melt = jnp.where(melting, jnp.minimum(Kf * temp_t, G), 0.0)
    return eTG, pot_melt


def _cemaneige_step(CTG, Kf, g_thresh, safe_g_thresh, snow_pack_init,
                    thermal_state_init):
    """Per-timestep plain-Cemaneige update, shared by the cold-start and
    warm-continuation kernels (the warm kernel feeds ``first_t=False``)."""
    def step(carry, x):
        G_prev, eTG_prev = carry
        snow_t, rain_t, temp_t, first_t = x

        G = jnp.where(first_t, snow_pack_init, G_prev + snow_t)
        eTG, pot_melt = _thermal_and_potential_melt(
            eTG_prev, temp_t, G, CTG, Kf, first_t, thermal_state_init)

        g_ratio = jnp.where(G < g_thresh, G / safe_g_thresh, 1.0)
        melt = (0.9 * g_ratio + MIN_MELT_SHARE) * pot_melt
        G = G - melt
        liquid = rain_t + melt
        return (G, eTG), (liquid, G, eTG)

    return step


def run_cemaneige(prec, mean_temp, frac_solid_prec, snow_pack_init,
                  thermal_state_init, params, *, unroll: int = 4,
                  return_final: bool = False):
    """Simulate the Cemaneige snow routine for a single parameter set.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) layer forcing series.
        snow_pack_init, thermal_state_init: scalar initial states (applied
            to every layer at t=0, reference ``cemaneige_model.py:85-96``).
        params: dict with scalar entries 'CTG', 'Kf'.
        return_final: also return ``(G, eTG, g_thresh)`` -- the final layer
            states plus this series' snow-cover threshold, i.e. exactly the
            inputs :func:`run_cemaneige_warm` needs to continue.

    Returns:
        outflow: (T,) catchment liquid-water outflow (mean over layers).
        G: (T, L) snowpack state.
        eTG: (T, L) snowpack thermal state.
        With ``return_final`` additionally the ``(G, eTG, g_thresh)`` tuple
        of (L,) arrays.
    """
    prec = jnp.asarray(prec)
    mean_temp = jnp.asarray(mean_temp)
    dtype = prec.dtype
    CTG, Kf = params['CTG'], params['Kf']

    snow, rain = _split_precipitation(prec, frac_solid_prec)
    # Snow-cover threshold from mean annual solid precipitation (per layer).
    g_thresh = 0.9 * 365.25 * jnp.mean(snow, axis=0)
    safe_g_thresh = jnp.where(g_thresh > 0, g_thresh, 1.0)

    num_layers = prec.shape[1]
    first = jnp.zeros(prec.shape[0], dtype=bool).at[0].set(True)
    init_G = jnp.zeros(num_layers, dtype=dtype)
    init_eTG = jnp.zeros(num_layers, dtype=dtype)

    step = _cemaneige_step(CTG, Kf, g_thresh, safe_g_thresh,
                           snow_pack_init, thermal_state_init)
    xs = (snow, rain, mean_temp, first)
    final, (liquid, G, eTG) = lax.scan(step, (init_G, init_eTG), xs,
                                       unroll=unroll)
    outflow = jnp.mean(liquid, axis=1)
    if return_final:
        return outflow, G, eTG, (final[0], final[1], g_thresh)
    return outflow, G, eTG


def _cemaneigehyst_step(CTG, Kf, Thacc, th_melt, snow_pack_init,
                        thermal_state_init):
    """Per-timestep hysteresis-Cemaneige update, shared by the cold-start
    and warm-continuation kernels (warm feeds ``first_t=False``)."""
    def step(carry, x):
        G_prev, eTG_prev, sca_prev, swe_max_prev = carry
        snow_t, rain_t, temp_t, first_t = x

        G = jnp.where(first_t, snow_pack_init, G_prev + snow_t)
        eTG, pot_melt = _thermal_and_potential_melt(
            eTG_prev, temp_t, G, CTG, Kf, first_t, thermal_state_init)

        snow_balance = snow_t - pot_melt
        accumulating = snow_balance >= 0

        # Accumulation phase: SCA grows with the SWE increment; track the
        # maximum SWE reached before melting starts.
        sca_acc = sca_prev + snow_balance / Thacc
        swe_max_acc = jnp.maximum(swe_max_prev, G)

        # Ablation phase: SCA follows SWE relative to Thmax.
        th_max = jnp.minimum(swe_max_prev, th_melt)
        sca_abl = jnp.where(th_max > 0, G / jnp.where(th_max > 0, th_max,
                                                      1.0), 0.0)

        sca = jnp.where(accumulating, sca_acc, sca_abl)
        swe_max = jnp.where(accumulating, swe_max_acc, swe_max_prev)
        sca = jnp.clip(sca, 0.0, 1.0)

        melt = (0.9 * sca + MIN_MELT_SHARE) * pot_melt
        melt = jnp.minimum(melt, G)
        G = G - melt
        # Reset the SWE maximum when the pack empties.
        swe_max = jnp.where(G == 0.0, 0.0, swe_max)

        liquid = rain_t + melt
        return (G, eTG, sca, swe_max), (liquid, G, eTG, sca)

    return step


def run_cemaneigehyst(prec, mean_temp, frac_solid_prec, snow_pack_init,
                      thermal_state_init, sca_init, params, *,
                      unroll: int = 4, return_final: bool = False):
    """Cemaneige with SWE-SCA linear hysteresis for a single parameter set.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) layer forcing series.
        snow_pack_init, thermal_state_init, sca_init: scalar initial states.
            Note: following the reference trajectory exactly, ``sca_init``
            does not influence the simulation -- the reference assigns it at
            t=0 but unconditionally overwrites it with the accumulation /
            ablation branch (``cemaneigehyst_model.py:100-143``, where the
            t=0 read of ``sca[t-1]`` wraps to a zero-initialized slot).
        params: dict with scalar entries 'CTG', 'Kf', 'Thacc', 'Rsp'.

    Returns:
        outflow: (T,) catchment outflow (mean over layers).
        G, eTG, sca, rain: (T, L) state/output series.
        With ``return_final`` additionally the
        ``(G, eTG, sca, swe_max, psol_annual)`` tuple of (L,) arrays --
        the final layer states plus this series' mean annual solid
        precipitation, i.e. exactly the inputs
        :func:`run_cemaneigehyst_warm` needs to continue.
    """
    del sca_init  # Kept for API parity; see docstring.
    prec = jnp.asarray(prec)
    mean_temp = jnp.asarray(mean_temp)
    dtype = prec.dtype
    CTG, Kf = params['CTG'], params['Kf']
    Thacc, Rsp = params['Thacc'], params['Rsp']

    snow, rain = _split_precipitation(prec, frac_solid_prec)
    psol_annual = 365.25 * jnp.mean(snow, axis=0)
    th_melt = psol_annual * Rsp

    num_layers = prec.shape[1]
    first = jnp.zeros(prec.shape[0], dtype=bool).at[0].set(True)
    zeros = jnp.zeros(num_layers, dtype=dtype)

    step = _cemaneigehyst_step(CTG, Kf, Thacc, th_melt, snow_pack_init,
                               thermal_state_init)
    xs = (snow, rain, mean_temp, first)
    init = (zeros, zeros, zeros, zeros)
    final, (liquid, G, eTG, sca) = lax.scan(step, init, xs, unroll=unroll)
    outflow = jnp.mean(liquid, axis=1)
    if return_final:
        return outflow, G, eTG, sca, rain, final + (psol_annual,)
    return outflow, G, eTG, sca, rain


def run_cemaneige_warm(prec, mean_temp, frac_solid_prec, state, g_thresh,
                       params, *, unroll: int = 4):
    """Continue a Cemaneige simulation from carried layer states.

    Forecast/continuation mode: every timestep advances the per-layer
    snowpack from ``state`` (no t=0 initialization), so chained segments
    reproduce an unbroken run.  Because the snow-cover threshold is a
    data-dependent precompute over the *training* series
    (``cemaneige_model.py:80``), it must be supplied explicitly here --
    pass ``0.9 * 365.25 * mean(solid precip)`` of the original series
    (per layer), NOT of the continuation segment.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) continuation forcing.
        state: tuple ``(G, eTG)`` of (L,) carried layer states.
        g_thresh: (L,) snow-cover thresholds from the original series.
        params: dict with scalar entries 'CTG', 'Kf'.

    Returns:
        (outflow, G, eTG, final_state) with ``final_state = (G_L, eTG_L)``.
    """
    prec = jnp.asarray(prec)
    mean_temp = jnp.asarray(mean_temp)
    dtype = prec.dtype
    CTG, Kf = params['CTG'], params['Kf']

    snow, rain = _split_precipitation(prec, frac_solid_prec)
    g_thresh = jnp.asarray(g_thresh, dtype)
    safe_g_thresh = jnp.where(g_thresh > 0, g_thresh, 1.0)

    # Same step as the cold kernel with first_t pinned False (the init
    # constants are then dead inputs).
    step = _cemaneige_step(CTG, Kf, g_thresh, safe_g_thresh, 0.0, 0.0)
    first = jnp.zeros(prec.shape[0], dtype=bool)
    init = tuple(jnp.asarray(v, dtype) for v in state)
    final, (liquid, G, eTG) = lax.scan(step, init,
                                       (snow, rain, mean_temp, first),
                                       unroll=unroll)
    return jnp.mean(liquid, axis=1), G, eTG, final


def run_cemaneigehyst_warm(prec, mean_temp, frac_solid_prec, state,
                           psol_annual, params, *, unroll: int = 4):
    """Continue a hysteresis-Cemaneige simulation from carried states.

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) continuation forcing.
        state: tuple ``(G, eTG, sca, swe_max)`` of (L,) carried states.
        psol_annual: (L,) mean annual solid precipitation of the ORIGINAL
            series (the hysteresis melt threshold is ``Rsp * psol_annual``,
            a data-dependent precompute -- same caveat as
            :func:`run_cemaneige_warm`).
        params: dict with scalar entries 'CTG', 'Kf', 'Thacc', 'Rsp'.

    Returns:
        (outflow, G, eTG, sca, rain, final_state).
    """
    prec = jnp.asarray(prec)
    mean_temp = jnp.asarray(mean_temp)
    dtype = prec.dtype
    CTG, Kf = params['CTG'], params['Kf']
    Thacc, Rsp = params['Thacc'], params['Rsp']

    snow, rain = _split_precipitation(prec, frac_solid_prec)
    th_melt = jnp.asarray(psol_annual, dtype) * Rsp

    # Same step as the cold kernel with first_t pinned False.
    step = _cemaneigehyst_step(CTG, Kf, Thacc, th_melt, 0.0, 0.0)
    first = jnp.zeros(prec.shape[0], dtype=bool)
    init = tuple(jnp.asarray(v, dtype) for v in state)
    final, (liquid, G, eTG, sca) = lax.scan(
        step, init, (snow, rain, mean_temp, first), unroll=unroll)
    return jnp.mean(liquid, axis=1), G, eTG, sca, rain, final


def run_icemelt(temp, snow, params):
    """Degree-day glacier ice melt; purely elementwise (no recurrence).

    Melt is suppressed where the snowpack exceeds 1 mm SWE (snow shields the
    ice), following the reference (``icemelt_model.py:54-63``).

    Args:
        temp: (T, L) mean temperature per layer.
        snow: (T, L) snowpack state per layer (G from the snow routine).
        params: dict with scalar entry 'DDF'.

    Returns:
        (T, L) ice-melt liquid water.
    """
    temp = jnp.asarray(temp)
    snow = jnp.asarray(snow)
    melt = jnp.maximum(params['DDF'] * (temp - MELT_TEMP), 0.0)
    return jnp.where(snow > SNOW_SHIELD_THRESHOLD, 0.0, melt)
