"""Fused kernels for the coupled snow + GR4J model family (Pallas, Triton).

One model template covers all four compositions of the reference
(``run_cemaneigegr4j``, ``run_cemaneigehystgr4j``, ``run_cemaneigegr4jice``,
``run_cemaneigehystgr4jice``) and standalone Cemaneige in their
Monte-Carlo / calibration, trajectory and forecast forms: the full coupled
model for a block of members runs inside one GPU program
(:mod:`rrmpg_jax.ops.fused`).  The elevation-layer axis is a static
unrolled loop; every snowpack state (G, eTG, and for the hysteresis
variant SCA and the SWE maximum) is a loop value in registers beside the
GR4J stores and UH registers.

Variant flags (``hyst``, ``ice``, ``snow_only``) are compile-time.  Math
follows the reference compositions exactly
(``rrmpg/models/cemaneigegr4j_model.py:56-63`` and siblings).
"""

import functools

import jax
import jax.numpy as jnp
from jax import lax

from . import fused
from .pallas_gr4j import gr4j_init, gr4j_rows, gr4j_step, push_history
from .uh import NUM_UH1, NUM_UH2


def _snow_layer(consts, l, first, snow_l, rain_l, temp_l, g, etg, sca, swe,
                hyst):
    """Advance one elevation layer one timestep.

    Returns ``(liquid, g, etg, sca, swe)``.  ``first`` is the t==0
    cold-start predicate; ``None`` for a warm continuation (no step is
    ever "first" -- the static specialization the warm XLA kernels use
    via ``first_t=False``, ``ops/cemaneige.py:118``).
    """
    CTG, Kf = consts['CTG'], consts['Kf']
    if first is None:
        g = g + snow_l
        th = CTG * etg + (1.0 - CTG) * temp_l
    else:
        g = jnp.where(first, consts['snow0'], g + snow_l)
        th = jnp.where(first, consts['th0'],
                       CTG * etg + (1.0 - CTG) * temp_l)
    th = jnp.minimum(th, 0.0)
    melting = (th == 0.0) & (temp_l > 0.0)
    pot_melt = jnp.where(melting, jnp.minimum(Kf * temp_l, g), 0.0)

    if hyst:
        th_melt = consts['lc'][l] * consts['Rsp']
        balance = snow_l - pot_melt
        accumulating = balance >= 0.0
        if first is not None:
            sca = jnp.where(first, 0.0, sca)
            swe = jnp.where(first, 0.0, swe)
        sca_acc = sca + balance * consts['ithacc']
        th_max = jnp.minimum(swe, th_melt)
        sca_abl = jnp.where(th_max > 0.0,
                            g / jnp.where(th_max > 0.0, th_max, 1.0), 0.0)
        sca = jnp.clip(jnp.where(accumulating, sca_acc, sca_abl), 0.0, 1.0)
        swe = jnp.where(accumulating, jnp.maximum(swe, g), swe)
        melt = jnp.minimum((0.9 * sca + 0.1) * pot_melt, g)
        g = g - melt
        swe = jnp.where(g == 0.0, 0.0, swe)
    else:
        g_thresh = consts['lc'][l]
        safe = jnp.where(g_thresh > 0.0, g_thresh, 1.0)
        ratio = jnp.where(g < g_thresh, g / safe, 1.0)
        melt = (0.9 * ratio + 0.1) * pot_melt
        g = g - melt
    return rain_l + melt, g, th, sca, swe


def _model(L, num_uh1, num_uh2, hyst, ice, snow_only=False, warm=False,
           final=False, sca_out=False):
    """The coupled family as a :class:`~rrmpg_jax.ops.fused.FusedModel`.

    Forcing columns: ``snow_0..L-1, rain_0..L-1, temp_0..L-1, etp``.
    ``sims`` is discharge, then (``sca_out``) ``100*SCA`` per layer for
    the Q+SCA statistics.  The final state is ``[s, r, hist.., G..,
    eTG.., sca.., swe_max..]`` (zeros for sca/swe without hysteresis).
    """
    h = num_uh2 - 1

    def init(row):
        consts = {'CTG': row('CTG'), 'Kf': row('Kf'),
                  'lc': [row(f'lc{l}') for l in range(L)]}
        if hyst:
            consts['Rsp'] = row('Rsp')
            consts['ithacc'] = row('ithacc')
        if ice:
            consts['DDF'] = row('DDF')
            consts['fi'] = [row(f'fi{l}') for l in range(L)]
        zero = jnp.zeros_like(consts['CTG'])
        keys = ('g', 'etg', 'sca', 'swe') if hyst else ('g', 'etg')
        if warm:
            snow = tuple(tuple(row(f'{k}{l}') for l in range(L))
                         for k in keys)
        else:
            consts['snow0'] = row('snow0')
            consts['th0'] = row('th0')
            snow = ((zero,) * L,) * len(keys)
        if not hyst:
            snow = snow + ((), ())
        gr = hist = ()
        if not snow_only:
            consts['gr4j'], gr = gr4j_init(row, num_uh1, num_uh2, warm)
            if final:
                hist = tuple(row(f'hist{j}') if warm else zero
                             for j in range(h))
        return consts, (snow, gr, hist)

    def step(consts, carry, x, first):
        (G, eTG, SCA, SWE), gr, hist = carry
        if warm:
            first = None
        liquid_sum = icemelt_sum = 0.0
        new = ([], [], [], [])
        for l in range(L):
            snow_l, rain_l, temp_l = x[l], x[L + l], x[2 * L + l]
            liquid, g, etg, sca, swe = _snow_layer(
                consts, l, first, snow_l, rain_l, temp_l, G[l], eTG[l],
                SCA[l] if hyst else None, SWE[l] if hyst else None, hyst)
            for k, v in enumerate((g, etg, sca, swe)):
                new[k].append(v)
            liquid_sum = liquid_sum + liquid
            if ice:
                melt = jnp.maximum(consts['DDF'] * temp_l, 0.0)
                icemelt_sum = icemelt_sum + jnp.where(g > 1.0, 0.0, melt) \
                    * consts['fi'][l]
        snow = tuple(tuple(v) for v in new[:2]) + (
            (tuple(new[2]), tuple(new[3])) if hyst else ((), ()))
        p = liquid_sum / float(L)
        if ice:
            p = p + icemelt_sum
        if snow_only:
            # Standalone Cemaneige: the catchment outflow IS the
            # layer-mean liquid (rain + melt); no runoff routing.
            q = p
        else:
            gr, q, p_r = gr4j_step(consts['gr4j'], gr, p, x[3 * L])
            if final:
                hist = push_history(hist, p_r)
        sims = (q,)
        if sca_out:
            sims += tuple(100.0 * sca for sca in snow[2])
        return (snow, gr, hist), sims

    def fin(consts, carry):
        (G, eTG, SCA, SWE), (s, r, _, _), hist = carry
        if not hyst:
            SCA = SWE = (jnp.zeros_like(s),) * L
        return (s, r) + hist + G + eTG + SCA + SWE

    return fused.FusedModel(init, step, fin if final else None)


def _layer_forcing(prec, mean_temp, frac_solid_prec, etp, dtype):
    """Forcing table ``(..., T, 3L + 1)`` and the snow series."""
    prec = jnp.asarray(prec, dtype)
    snow = prec * jnp.asarray(frac_solid_prec, dtype)
    rain = prec - snow
    table = jnp.concatenate([snow, rain, jnp.asarray(mean_temp, dtype),
                             jnp.asarray(etp, dtype)[..., None]], axis=-1)
    return table, snow


def _family_rows(params, dtype, *, hyst, ice, snow_only, layer_consts,
                 frac_ice, snow_pack_init=0.0, thermal_state_init=0.0,
                 s_init=0.0, r_init=0.0, state=None, h=0):
    """Per-member rows of the family kernels.

    ``layer_consts`` (snow-cover threshold, or mean annual solid
    precipitation with hysteresis) and ``frac_ice`` may be ``(L,)``
    (shared), ``(N, L)`` (per member, carried in a state bundle) or
    ``(C, 1, L)`` (per catchment).  With ``state`` (a batched
    :class:`~rrmpg_jax.models.states.SnowGR4JState`) the per-layer snow
    state and the GR4J stores / routing history enter from the bundle.
    """
    def param(key):
        return jnp.asarray(params[key], dtype)

    rows = {'CTG': param('CTG'), 'Kf': param('Kf')}
    if hyst:
        rows['Rsp'] = param('Rsp')
        rows['ithacc'] = 1.0 / param('Thacc')
    if ice:
        rows['DDF'] = param('DDF')
    layer_consts = jnp.asarray(layer_consts, dtype)
    L = layer_consts.shape[-1]
    for l in range(L):
        rows[f'lc{l}'] = layer_consts[..., l]
        if ice:
            rows[f'fi{l}'] = jnp.asarray(frac_ice, dtype)[..., l]
    if state is None:
        rows['snow0'] = jnp.asarray(snow_pack_init, dtype)
        rows['th0'] = jnp.asarray(thermal_state_init, dtype)
    else:
        sg = state.snow
        leaves = {'g': sg.g, 'etg': sg.etg}
        if hyst:
            leaves.update(sca=sg.sca, swe=sg.swe_max)
        for k, leaf in leaves.items():
            for l in range(L):
                rows[f'{k}{l}'] = jnp.asarray(leaf, dtype)[:, l]
    if not snow_only:
        rows.update(gr4j_rows(params, jnp.asarray(s_init, dtype),
                              jnp.asarray(r_init, dtype), dtype,
                              state=None if state is None else state.gr4j,
                              h=h))
    return rows


def _series_consts(snow, hyst, axis):
    """Snow-cover threshold (plain) or mean annual solid precipitation
    (hysteresis) per layer, from the run's own snow series."""
    psol = 365.25 * jnp.mean(snow, axis=axis)
    return psol if hyst else 0.9 * psol


def _warm_layer_consts(state, hyst):
    sg = state.snow
    return sg.psol_annual if hyst else sg.g_thresh            # (N, L)


@functools.partial(jax.jit, static_argnames=(
    "hyst", "ice", "stats", "sca_stats", "snow_only", "num_uh1", "num_uh2",
    "block", "interpret", "warm", "masked"))
def snowgr4j_ensemble_mse_pallas(prec, mean_temp, etp, frac_solid_prec,
                                 qobs, snow_pack_init, thermal_state_init,
                                 s_init, r_init, params, frac_ice=None,
                                 ndsi=None, hyst=False, ice=False,
                                 stats=False, sca_stats=False,
                                 snow_only=False, num_uh1=NUM_UH1,
                                 num_uh2=NUM_UH2, block=None,
                                 interpret=False, state=None, warm=None,
                                 masked=False):
    """Fused coupled-model ensemble MSE; returns (N,) losses.

    With ``stats=True``, returns a (4, N) array of time-mean sufficient
    statistics [mse, mean(q), mean(q^2), mean(q*qobs)] from which
    KGE/NSE/correlation objectives are computed with
    :func:`losses_from_stats` -- still one device pass, no trajectories.

    With ``sca_stats=True`` (requires ``hyst=True`` and ``ndsi`` of shape
    (L, T)), returns (4 + 4*L, N): the discharge statistics followed by
    per-band statistics of 100*SCA vs NDSI for the multi-objective Q+SCA
    calibration (combine with :func:`q_sca_loss_from_stats`).

    Args:
        prec, mean_temp, frac_solid_prec: (T, L) layer forcing.
        etp, qobs: (T,) series.
        snow_pack_init, thermal_state_init, s_init, r_init: scalars
            (reference init conventions).
        params: dict of (N,) arrays -- CTG, Kf, x1..x4 and, per variant,
            Thacc/Rsp (hyst) and DDF (ice).
        frac_ice: (L,) glacier fractions (ice variants).
        hyst, ice: compile-time variant selectors.
        state: (optional) batched
            :class:`~rrmpg_jax.models.states.SnowGR4JState` (every leaf
            carrying the member axis) -- the objective evaluates a WARM
            continuation: snowpack/GR4J state enters from the bundle and
            the series-derived layer constants come from the ORIGINAL
            series (carried in the bundle), never recomputed from this
            (shorter) segment.  The fused path for
            ``fit(initial_state=, engine='pallas')``.  ``warm``
            statically overrides ``state is not None``.
        masked: (compile-time) treat NaN observations as missing-data
            gaps -- excluded from the accumulations, each series by its
            own gaps (discharge and, with ``sca_stats``, each NDSI
            band), with the means renormalized over the valid counts.
        block: members per program (:mod:`rrmpg_jax.ops.fused`).
    """
    dtype = jnp.asarray(prec).dtype
    if warm is None:
        warm = state is not None
    if warm and sca_stats:
        raise ValueError(
            "Warm (state=) evaluation supports the mse/stats "
            "objectives; Q+SCA calibration from a carried state "
            "runs on engine='xla'.")
    if sca_stats and not hyst:
        raise ValueError("sca_stats requires the hysteresis variant.")
    forcing, snow = _layer_forcing(prec, mean_temp, frac_solid_prec, etp,
                                   dtype)
    L = snow.shape[-1]
    layer_consts = (_warm_layer_consts(state, hyst) if warm
                    else _series_consts(snow, hyst, axis=0))
    rows = _family_rows(params, dtype, hyst=hyst, ice=ice,
                        snow_only=snow_only, layer_consts=layer_consts,
                        frac_ice=frac_ice, snow_pack_init=snow_pack_init,
                        thermal_state_init=thermal_state_init,
                        s_init=s_init, r_init=r_init,
                        state=state if warm else None, h=num_uh2 - 1)
    obs = jnp.asarray(qobs, dtype)[:, None]
    if sca_stats:
        obs = jnp.concatenate([obs, jnp.asarray(ndsi, dtype)[:L].T],
                              axis=1)
    (out,) = fused.run(
        _model(L, num_uh1, num_uh2, hyst, ice, snow_only=snow_only,
               warm=warm, sca_out=sca_stats),
        forcing[None], rows, obs=obs[None], stats=stats or sca_stats,
        masked=masked, block=block, interpret=interpret,
        name="snowgr4j_objective")
    out = out[0]
    return out if stats or sca_stats else out[0]


@functools.partial(jax.jit, static_argnames=(
    "hyst", "ice", "snow_only", "num_uh1", "num_uh2", "block",
    "interpret"))
def snowgr4j_simulate_pallas(prec, mean_temp, etp, frac_solid_prec,
                             snow_pack_init, thermal_state_init, s_init,
                             r_init, params, frac_ice=None, hyst=False,
                             ice=False, snow_only=False, num_uh1=NUM_UH1,
                             num_uh2=NUM_UH2, block=None, interpret=False):
    """Fused coupled-model ensemble simulation; returns qsim (N, T).

    Trajectory variant of :func:`snowgr4j_ensemble_mse_pallas`: the same
    fused composition, writing the discharge series per member (use the
    XLA path for storage trajectories).
    """
    dtype = jnp.asarray(prec).dtype
    forcing, snow = _layer_forcing(prec, mean_temp, frac_solid_prec, etp,
                                   dtype)
    L = snow.shape[-1]
    rows = _family_rows(params, dtype, hyst=hyst, ice=ice,
                        snow_only=snow_only,
                        layer_consts=_series_consts(snow, hyst, axis=0),
                        frac_ice=frac_ice, snow_pack_init=snow_pack_init,
                        thermal_state_init=thermal_state_init,
                        s_init=s_init, r_init=r_init)
    (qsim,) = fused.run(_model(L, num_uh1, num_uh2, hyst, ice,
                               snow_only=snow_only),
                        forcing[None], rows, traj=True, block=block,
                        interpret=interpret, name="snowgr4j_traj")
    return qsim[0].T


@functools.partial(jax.jit, static_argnames=(
    "hyst", "ice", "num_uh1", "num_uh2", "block", "interpret",
    "warm"))
def snowgr4j_simulate_pallas_state(prec, mean_temp, etp, frac_solid_prec,
                                   params, state=None, snow_pack_init=0.0,
                                   thermal_state_init=0.0, s_init=0.0,
                                   r_init=0.0, frac_ice=None, hyst=False,
                                   ice=False, num_uh1=NUM_UH1,
                                   num_uh2=NUM_UH2, block=None,
                                   interpret=False,
                                   warm=None):
    """Forecast-mode fused snow+GR4J simulation.

    Returns ``(qsim (N, T), final SnowGR4JState)`` -- the fused
    counterpart of the warm/cold-final XLA composition kernels
    (``ops/compositions.py``): all snowpack and runoff state enters from a
    carried :class:`~rrmpg_jax.models.states.SnowGR4JState` (``state=``,
    every leaf batched over members) and leaves as one row per state
    variable and member.  The series-derived constants travel with the
    state: a warm segment uses the ORIGINAL series' snow-cover threshold
    / annual solid precipitation from the bundle, never recomputing them
    from its own (shorter) forcing.

    Args:
        state: (optional) batched SnowGR4JState (``pr_history`` is
            trimmed to the last ``num_uh2 - 1`` inputs); cold
            reference-convention inits otherwise.
        warm: static override of ``state is not None`` (internal).
    """
    from ..models.states import (
        CemaneigeHystState,
        CemaneigeState,
        SnowGR4JState,
    )
    from .gr4j import GR4JState

    dtype = jnp.asarray(prec).dtype
    h = num_uh2 - 1
    if warm is None:
        warm = state is not None
    forcing, snow = _layer_forcing(prec, mean_temp, frac_solid_prec, etp,
                                   dtype)
    L = snow.shape[-1]
    layer_consts = (_warm_layer_consts(state, hyst) if warm
                    else _series_consts(snow, hyst, axis=0))
    rows = _family_rows(params, dtype, hyst=hyst, ice=ice, snow_only=False,
                        layer_consts=layer_consts, frac_ice=frac_ice,
                        snow_pack_init=snow_pack_init,
                        thermal_state_init=thermal_state_init,
                        s_init=s_init, r_init=r_init,
                        state=state if warm else None, h=h)
    qsim, fs = fused.run(
        _model(L, num_uh1, num_uh2, hyst, ice, warm=warm, final=True),
        forcing[None], rows, traj=True, n_final=2 + h + 4 * L, block=block,
        interpret=interpret, name="snowgr4j_traj_state")
    fs = fs[0]
    n = fs.shape[-1]
    gr4j_final = GR4JState(s=fs[0], r=fs[1], pr_history=fs[2:2 + h].T)
    layers = [fs[2 + h + k * L:2 + h + (k + 1) * L].T for k in range(4)]
    consts = jnp.broadcast_to(layer_consts, (n, L))
    if hyst:
        snow_final = CemaneigeHystState(g=layers[0], etg=layers[1],
                                        sca=layers[2], swe_max=layers[3],
                                        psol_annual=consts)
    else:
        snow_final = CemaneigeState(g=layers[0], etg=layers[1],
                                    g_thresh=consts)
    return qsim[0].T, SnowGR4JState(snow=snow_final, gr4j=gr4j_final)


def cemaneige_simulate_pallas(prec, mean_temp, frac_solid_prec,
                              snow_pack_init, thermal_state_init, params,
                              block=None, interpret=False):
    """Fused standalone-Cemaneige ensemble simulation; returns (N, T).

    Snow-only mode of the family kernel: the catchment outflow (layer-mean
    rain + melt, ``rrmpg/models/cemaneige_model.py:121-125``) is written
    per member.
    """
    etp = jnp.zeros(jnp.asarray(prec).shape[0],
                    jnp.asarray(prec).dtype)      # unused in snow_only
    return snowgr4j_simulate_pallas(
        prec, mean_temp, etp, frac_solid_prec, snow_pack_init,
        thermal_state_init, 0.0, 0.0, params, snow_only=True,
        num_uh1=1, num_uh2=1, block=block, interpret=interpret)


def cemaneige_ensemble_mse_pallas(prec, mean_temp, frac_solid_prec, qobs,
                                  snow_pack_init, thermal_state_init,
                                  params, block=None, interpret=False,
                                  stats=False, masked=False):
    """Fused standalone-Cemaneige ensemble MSE; returns (N,) losses
    ((4, N) sufficient statistics with ``stats=True``).  ``masked``
    excludes NaN observations (missing-data gaps)."""
    etp = jnp.zeros(jnp.asarray(prec).shape[0],
                    jnp.asarray(prec).dtype)
    return snowgr4j_ensemble_mse_pallas(
        prec, mean_temp, etp, frac_solid_prec, qobs, snow_pack_init,
        thermal_state_init, 0.0, 0.0, params, snow_only=True, stats=stats,
        num_uh1=1, num_uh2=1, block=block, interpret=interpret,
        masked=masked)


@functools.partial(jax.jit, static_argnames=(
    "hyst", "ice", "stats", "num_uh1", "num_uh2", "block",
    "interpret", "masked"))
def snowgr4j_regional_mse_pallas(prec, mean_temp, etp, frac_solid_prec,
                                 qobs, snow_pack_init, thermal_state_init,
                                 s_init, r_init, params, frac_ice=None,
                                 hyst=False, ice=False, stats=False,
                                 num_uh1=NUM_UH1, num_uh2=NUM_UH2,
                                 block=None, interpret=False, masked=False):
    """Fused regional coupled-model MC objective; returns (C, N) losses.

    The (catchment x member) extension of
    :func:`snowgr4j_ensemble_mse_pallas`: the grid's first axis walks the
    catchments, each with its own layer forcing, observations, per-layer
    snow thresholds (``G_tresh`` / annual solid precipitation are
    catchment-local precomputes) and optionally per-catchment glacier
    fractions -- one float per (catchment, member) leaves the card.

    Args:
        prec, mean_temp, frac_solid_prec: (C, T, L) layer forcing.
        etp, qobs: (C, T) series.
        params: dict of (N,) member parameter arrays, shared across
            catchments.
        frac_ice: (L,) shared or (C, L) per-catchment glacier fractions.
        stats: return (4, C, N) sufficient statistics instead of MSE.
        masked: (compile-time) exclude NaN observations, normalizing
            each catchment over its own valid count -- ragged discharge
            records (NaN-padded to rectangular) calibrate correctly.
    """
    dtype = jnp.asarray(prec).dtype
    forcing, snow = _layer_forcing(prec, mean_temp, frac_solid_prec, etp,
                                   dtype)
    C, _, L = snow.shape
    if frac_ice is not None:
        frac_ice = jnp.broadcast_to(jnp.asarray(frac_ice, dtype),
                                    (C, L))[:, None, :]
    # One catchment at a time (lax.map): the constants then round the
    # same whatever the number of catchments, so a catchment-sharded run
    # matches the one-device run exactly.
    layer_consts = lax.map(lambda s: _series_consts(s, hyst, axis=0), snow)
    rows = _family_rows(params, dtype, hyst=hyst, ice=ice, snow_only=False,
                        layer_consts=layer_consts[:, None, :],
                        frac_ice=frac_ice, snow_pack_init=snow_pack_init,
                        thermal_state_init=thermal_state_init,
                        s_init=s_init, r_init=r_init)
    (out,) = fused.run(_model(L, num_uh1, num_uh2, hyst, ice), forcing,
                       rows, obs=jnp.asarray(qobs, dtype)[..., None],
                       stats=stats, masked=masked, block=block,
                       interpret=interpret,
                       name="snowgr4j_regional_objective")
    if stats:
        return out.transpose(1, 0, 2)                 # (4, C, N)
    return out[:, 0]                                  # (C, N)


def losses_from_stats(stats, qobs):
    """Compute objective values from fused-kernel sufficient statistics.

    Args:
        stats: (4, N) array [mse, mean_q, mean_q2, mean_q_qobs] as returned
            by ``snowgr4j_ensemble_mse_pallas(..., stats=True)``.
        qobs: (T,) observations.

    Returns:
        dict with (N,) arrays: 'mse', 'rmse', 'nse', 'kge', 'alpha', 'beta',
        'r' (KGE decomposition follows ``rrmpg/utils/metrics.py:182-188``).

    NaN observations (missing-data gaps) are excluded from the
    observation moments, matching the masked kernel statistics
    (``masked=True`` on the fused kernels normalizes the member
    statistics over the same valid steps).
    """
    qobs = jnp.asarray(qobs, stats.dtype)
    w = jnp.isfinite(qobs).astype(stats.dtype)
    qobs0 = jnp.where(w > 0, qobs, 0.0)
    n = jnp.sum(w)
    mean_obs = jnp.sum(w * qobs0) / n
    var_obs = jnp.sum(w * qobs0 * qobs0) / n - mean_obs * mean_obs
    std_obs = jnp.sqrt(jnp.maximum(var_obs, 0.0))

    mse_v, mean_q, mean_q2, mean_qo = stats
    var_q = jnp.maximum(mean_q2 - mean_q * mean_q, 0.0)
    std_q = jnp.sqrt(var_q)
    cov = mean_qo - mean_q * mean_obs
    r = cov / (std_q * std_obs)
    alpha = std_q / std_obs
    beta = mean_q / mean_obs
    kge = 1.0 - jnp.sqrt((r - 1.0) ** 2 + (alpha - 1.0) ** 2 +
                         (beta - 1.0) ** 2)
    nse = 1.0 - mse_v / var_obs
    return {'mse': mse_v, 'rmse': jnp.sqrt(mse_v), 'nse': nse, 'kge': kge,
            'alpha': alpha, 'beta': beta, 'r': r}


def q_sca_loss_from_stats(stats, qobs, ndsi, loss_metric="mse"):
    """Multi-objective Q+SCA loss from fused-kernel statistics.

    Implements the reference weighting (0.75 on discharge, 0.05 per
    elevation band, ``rrmpg/models/cemaneigehystgr4j.py:663-689``) with
    'mse', or 'kge' minimizing ``1 - KGE`` per term.

    Args:
        stats: (4 + 4*L, N) array from
            ``snowgr4j_ensemble_mse_pallas(..., sca_stats=True)``.
        qobs: (T,) observed discharge.
        ndsi: (L, T) observed NDSI bands.

    Returns:
        (N,) combined losses.
    """
    loss_q, loss_sca = q_sca_components_from_stats(stats, qobs, ndsi,
                                                   loss_metric)
    return 0.75 * loss_q + 0.05 * loss_sca


def q_sca_components_from_stats(stats, qobs, ndsi, loss_metric="mse"):
    """Separate (L_q, L_sca) components from fused-kernel statistics.

    Same statistics as :func:`q_sca_loss_from_stats` but without the
    reference's fixed weighting -- the bi-objective form that
    ``fit_Q_SCA(pareto=True)`` optimizes with NSGA-II.  ``L_sca`` is the
    sum over the elevation bands (the unweighted analog of the
    reference's ``sum_b L(NDSI_b, 100 sca_b)``).

    Returns:
        ``(loss_q, loss_sca)``, each ``(N,)``.
    """
    L = (stats.shape[0] - 4) // 4
    q_losses = losses_from_stats(stats[:4], qobs)
    if loss_metric == "mse":
        loss_q = q_losses['mse']
        loss_sca = sum(stats[4 + 4 * l] for l in range(L))
        return loss_q, loss_sca
    if loss_metric == "kge":
        loss_q = 1.0 - q_losses['kge']
        loss_sca = sum(
            1.0 - losses_from_stats(stats[4 + 4 * l:8 + 4 * l],
                                    ndsi[l])['kge']
            for l in range(L))
        return loss_q, loss_sca
    raise ValueError(
        f"Unsupported loss_metric {loss_metric!r}; supported: 'mse', 'kge'.")
