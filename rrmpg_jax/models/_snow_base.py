"""Shared validation + met-preprocessing for the Cemaneige model family.

The five snow models of the reference duplicate ~150 lines of validation
and elevation-layer preprocessing per class
(e.g. ``rrmpg/models/cemaneige.py:132-200``); here it lives once.
Error types and messages match the reference.
"""

import functools
import numbers

import numpy as np

from ..ops.met import (
    calculate_solid_fraction,
    extrapolate_precipitation,
    extrapolate_temperature,
)
from ..utils.array_checks import check_for_negatives, validate_array_input
from .basemodel import BaseModel
from .states import (
    CemaneigeHystState,
    CemaneigeState,
    SnowGR4JState,
    check_state_type,
    normalize_state,
)


class CemaneigeBase(BaseModel):
    """Base class for models containing the Cemaneige snow routine."""

    @staticmethod
    def _validate_met(prec, mean_temp, min_temp, max_temp,
                      met_station_height, altitudes, extra_series=()):
        """Validate inputs and extrapolate them to elevation layers.

        Args:
            prec, mean_temp, min_temp, max_temp: (T,) station series.
            met_station_height: station elevation [m].
            altitudes: list of median layer elevations (may be empty for a
                single layer at station height).
            extra_series: additional (name, array) pairs that must have the
                same length as prec (e.g. etp, NDSI bands); returned
                validated in order.

        Returns:
            (prec, mean_temp, frac_solid_prec, altitudes, extras) with
            layer arrays of shape (T, L).
        """
        prec = validate_array_input(prec, np.float64, 'prec')
        mean_temp = validate_array_input(mean_temp, np.float64, 'mean_temp')
        min_temp = validate_array_input(min_temp, np.float64, 'min_temp')
        max_temp = validate_array_input(max_temp, np.float64, 'max_temp')
        extras = [validate_array_input(arr, np.float64, name)
                  for name, arr in extra_series]

        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")

        if any(len(ar) != len(prec)
               for ar in [mean_temp, min_temp, max_temp] + extras):
            raise RuntimeError(
                "Every meteorological series passed to this model needs the "
                f"same length as prec ({len(prec)}).")

        if not isinstance(altitudes, list):
            raise TypeError(
                f"'altitudes' expects a list of elevation-band heights, got "
                f"{type(altitudes).__name__}.")
        if len(altitudes) > 0:
            bad = [v for v in altitudes if not isinstance(v, numbers.Number)]
            if bad:
                raise TypeError(
                    f"'altitudes' contains non-numeric entries: {bad}.")
            if met_station_height is None:
                raise ValueError(
                    "Elevation-band extrapolation needs "
                    "'met_station_height', which was not given.")
            if not isinstance(met_station_height, numbers.Number):
                raise TypeError(
                    "'met_station_height' needs a numeric scalar, got "
                    f"{type(met_station_height).__name__}.")
            altitudes = np.array(altitudes)

        if not isinstance(met_station_height, numbers.Number):
            raise TypeError(
                "'met_station_height' needs a numeric scalar, got "
                f"{type(met_station_height).__name__}.")

        if len(altitudes) > 0:
            prec = np.asarray(extrapolate_precipitation(
                prec, altitudes, met_station_height))
            min_temp, mean_temp, max_temp = (
                np.asarray(a) for a in extrapolate_temperature(
                    min_temp, mean_temp, max_temp, altitudes,
                    met_station_height))
        else:
            prec = np.expand_dims(prec, axis=-1)
            mean_temp = np.expand_dims(mean_temp, axis=-1)
            min_temp = np.expand_dims(min_temp, axis=-1)
            max_temp = np.expand_dims(max_temp, axis=-1)
            altitudes = np.array([met_station_height])

        frac_solid_prec = np.asarray(calculate_solid_fraction(
            prec, altitudes, mean_temp, min_temp, max_temp))

        return prec, mean_temp, frac_solid_prec, altitudes, extras

    @staticmethod
    def _validate_number(value, name):
        if not isinstance(value, numbers.Number):
            raise TypeError(
                f"'{name}' needs a numeric scalar, got {type(value).__name__}.")
        return float(value)

    def _pallas_batch_objective(self, loss_metric, prec, mean_temp, etp,
                                frac_solid_prec, qobs, snow_pack_init,
                                thermal_state_init, s_init, r_init,
                                frac_ice=None, hyst=False, ice=False,
                                interpret=False):
        """Build a batched DE objective backed by the fused Pallas kernel.

        Maps a (P, dim) candidate matrix (columns ordered as
        ``_param_list``) to (P,) losses in one fused device pass --
        'mse'/'rmse' accumulate squared error; 'nse'/'kge' run the
        stats variant and minimize ``1 - score``.
        """
        import jax.numpy as jnp

        from ..ops.pallas_snow import (
            losses_from_stats,
            snowgr4j_ensemble_mse_pallas,
        )

        if loss_metric not in ("mse", "rmse", "nse", "kge"):
            raise ValueError(
                f"Unsupported loss_metric {loss_metric!r}; "
                "supported: 'mse', 'rmse', 'nse', 'kge'.")
        use_stats = loss_metric in ("nse", "kge")

        args = tuple(jnp.asarray(a) for a in
                     (prec, mean_temp, etp, frac_solid_prec, qobs))
        fi = None if frac_ice is None else jnp.asarray(frac_ice)
        names = self._param_list
        from .gr4j import fit_uh_lengths
        num_uh1, num_uh2 = fit_uh_lengths(self._default_bounds['x4'][1])
        qobs_j = args[4]
        # NaN observations = missing-data gaps -> masked kernel.
        masked = bool(np.isnan(np.asarray(qobs)).any())

        def batch_objective(X):
            params = {name: X[:, i] for i, name in enumerate(names)}
            out = snowgr4j_ensemble_mse_pallas(
                *args, snow_pack_init, thermal_state_init, s_init, r_init,
                params, frac_ice=fi, hyst=hyst, ice=ice,
                stats=use_stats, num_uh1=num_uh1,
                num_uh2=num_uh2, interpret=interpret, masked=masked)
            if use_stats:
                return 1.0 - losses_from_stats(out, qobs_j)[loss_metric]
            if loss_metric == "rmse":
                return jnp.sqrt(out)
            return out

        return batch_objective

    def _fused_stats_family(self, qobs, param_dict, sim_kwargs, *, hyst,
                            ice):
        """(4, N) time-mean sufficient statistics of the fused coupled
        objective kernel (see ``GR4J._fused_stats``): the
        trajectory-free evaluation behind
        ``monte_carlo(return_qsim=False, engine='pallas')``."""
        import jax.numpy as jnp

        from ..ops.pallas_snow import snowgr4j_ensemble_mse_pallas
        from .gr4j import GR4J

        kw = dict(sim_kwargs)
        kw.pop("engine", None)
        interpret = kw.pop("interpret", False)
        if kw.pop("mesh", None) is not None:
            raise ValueError(
                "The fused statistics path runs single-device; drop "
                "mesh= (shard with parallel.ensemble instead) or keep "
                "return_qsim=True.")
        prec = kw.pop("prec")
        mean_temp = kw.pop("mean_temp")
        min_temp = kw.pop("min_temp")
        max_temp = kw.pop("max_temp")
        etp = kw.pop("etp")
        met_station_height = kw.pop("met_station_height")
        altitudes = kw.pop("altitudes", [])
        frac_ice = kw.pop("frac_ice", None) if ice else None
        if hyst:
            kw.pop("sca_init", None)  # inert (reference parity)
        sp = self._validate_number(kw.pop("snow_pack_init", 0),
                                   'snow_pack_init')
        ts = self._validate_number(kw.pop("thermal_state_init", 0),
                                   'thermal_state_init')
        s_init, r_init = GR4J._validate_inits(kw.pop("s_init", 0),
                                              kw.pop("r_init", 0))
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for the fused statistics "
                f"path: {sorted(kw)}.")
        if ice and frac_ice is None:
            raise ValueError(
                f"{type(self).__name__} needs 'frac_ice'.")
        prec_l, mt_l, fsp, _, (etp_v,) = self._validate_met(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes,
            extra_series=(('pot. evapotranspiration', etp),))
        fi = (None if frac_ice is None
              else jnp.asarray(self._validate_frac_ice(frac_ice)))
        from .gr4j import fit_uh_lengths
        n1, n2 = fit_uh_lengths(self._default_bounds['x4'][1])
        return snowgr4j_ensemble_mse_pallas(
            jnp.asarray(prec_l), jnp.asarray(mt_l), jnp.asarray(etp_v),
            jnp.asarray(fsp), jnp.asarray(qobs), sp, ts, s_init, r_init,
            {k: jnp.asarray(v) for k, v in param_dict.items()},
            frac_ice=fi, hyst=hyst, ice=ice, stats=True, num_uh1=n1,
            num_uh2=n2, interpret=interpret,
            masked=bool(np.isnan(np.asarray(qobs)).any()))

    def _pallas_q_sca_objective(self, loss_metric, prec, mean_temp, etp,
                                frac_solid_prec, qobs, ndsi,
                                snow_pack_init, thermal_state_init,
                                s_init, r_init, frac_ice=None, ice=False,
                                interpret=False, components=False):
        """Batched Q+SCA objective backed by the fused kernel.

        Accumulates discharge and per-band 100*SCA statistics on-device;
        the reference's 0.75 / 5 x 0.05 weighting is applied host-side
        from those statistics (``q_sca_loss_from_stats``).  With
        ``components=True`` the objective instead returns the stacked
        (N, 2) ``(L_q, L_sca)`` pair for bi-objective (Pareto)
        calibration.
        """
        import jax.numpy as jnp

        from ..ops.pallas_snow import (
            q_sca_components_from_stats,
            q_sca_loss_from_stats,
            snowgr4j_ensemble_mse_pallas,
        )

        if loss_metric not in ("mse", "rmse", "nse", "kge"):
            raise ValueError(
                f"Unsupported loss_metric {loss_metric!r}; "
                "supported: 'mse', 'rmse', 'nse', 'kge'.")
        use_stats = loss_metric in ("nse", "kge")

        args = tuple(jnp.asarray(a) for a in
                     (prec, mean_temp, etp, frac_solid_prec, qobs))
        ndsi_j = jnp.stack([jnp.asarray(n) for n in ndsi])  # (L, T)
        fi = None if frac_ice is None else jnp.asarray(frac_ice)
        names = self._param_list
        from .gr4j import fit_uh_lengths
        num_uh1, num_uh2 = fit_uh_lengths(self._default_bounds['x4'][1])
        qobs_j = args[4]
        # NaN gaps in discharge or any NDSI band -> masked kernel
        # (each series masks by its own gaps).
        masked = bool(np.isnan(np.asarray(qobs)).any()
                      or np.isnan(np.asarray(ndsi_j)).any())

        def batch_objective(X):
            params = {name: X[:, i] for i, name in enumerate(names)}
            stats = snowgr4j_ensemble_mse_pallas(
                *args, snow_pack_init, thermal_state_init, s_init, r_init,
                params, frac_ice=fi, ndsi=ndsi_j, hyst=True, ice=ice,
                sca_stats=True, num_uh1=num_uh1, num_uh2=num_uh2,
                interpret=interpret, masked=masked)
            if components:
                loss_q, loss_sca = q_sca_components_from_stats(
                    stats, qobs_j, ndsi_j, loss_metric)
                return jnp.stack([loss_q, loss_sca], axis=1)
            return q_sca_loss_from_stats(stats, qobs_j, ndsi_j,
                                         loss_metric)

        return batch_objective

    def _pallas_simulate(self, param_dict, prec, mean_temp, etp,
                         frac_solid_prec, snow_pack_init,
                         thermal_state_init, s_init, r_init,
                         frac_ice=None, hyst=False, ice=False,
                         interpret=False):
        """Discharge-only fused simulation for the composition classes."""
        from ..ops.pallas_snow import snowgr4j_simulate_pallas
        from ..ops.uh import required_uh_lengths

        n1, n2 = required_uh_lengths(param_dict['x4'])
        qsim = snowgr4j_simulate_pallas(
            prec, mean_temp, etp, frac_solid_prec, snow_pack_init,
            thermal_state_init, s_init, r_init, param_dict,
            frac_ice=frac_ice, hyst=hyst, ice=ice, num_uh1=n1,
            num_uh2=n2, interpret=interpret)
        return np.moveaxis(np.asarray(qsim), 0, -1)

    # ------------------------------------------------------------------
    # Forecast mode (state-carrying simulation) for the composition classes
    # ------------------------------------------------------------------

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _stateful_kernels(hyst, ice, num_uh1, num_uh2):
        """(cold, warm) kernel pair for a snow + GR4J composition.

        Both return the class's reference-ordered series followed by a
        :class:`~rrmpg_jax.models.states.SnowGR4JState` bundle.  The ice
        variants take ``frac_ice`` as an additional shared forcing right
        after ``etp`` (matching the cold kernels' argument order).
        """
        from ..ops.cemaneige import run_cemaneigehyst_warm
        from ..ops.compositions import (
            _weighted_icemelt,
            run_cemaneigegr4j,
            run_cemaneigegr4j_warm,
            run_cemaneigegr4jice,
            run_cemaneigehystgr4j,
            run_cemaneigehystgr4j_warm,
            run_cemaneigehystgr4jice,
        )
        from ..ops.gr4j import run_gr4j_warm

        snow_cls = CemaneigeHystState if hyst else CemaneigeState

        def bundle(final):
            snow_final, gr4j_final = final
            return SnowGR4JState(snow=snow_cls(*snow_final),
                                 gr4j=gr4j_final)

        def rebundle(snow_carry, gr4j_final, old_snow):
            # Warm kernels return only the evolving carry; the series-
            # derived constant (g_thresh / psol_annual) passes through.
            const = old_snow[-1]
            return SnowGR4JState(snow=snow_cls(*snow_carry, const),
                                 gr4j=gr4j_final)

        if not hyst and not ice:
            def cold(prec, mean_temp, etp, frac_solid, sp, ts, s, r,
                     params):
                *series, fin = run_cemaneigegr4j(
                    prec, mean_temp, etp, frac_solid, sp, ts, s, r,
                    params, num_uh1, num_uh2, return_final=True)
                return tuple(series) + (bundle(fin),)

            def warm(prec, mean_temp, etp, frac_solid, state, params):
                qsim, G, eTG, s_store, r_store, _, fin = (
                    run_cemaneigegr4j_warm(
                        prec, mean_temp, etp, frac_solid,
                        ((state.snow.g, state.snow.etg), state.gr4j),
                        state.snow.g_thresh, params, num_uh1, num_uh2))
                return (qsim, G, eTG, s_store, r_store,
                        rebundle(fin[0], fin[1], state.snow))
        elif not hyst and ice:
            def cold(prec, mean_temp, etp, frac_ice, frac_solid, sp, ts,
                     s, r, params):
                *series, fin = run_cemaneigegr4jice(
                    prec, mean_temp, etp, frac_ice, frac_solid, sp, ts,
                    s, r, params, num_uh1, num_uh2, return_final=True)
                return tuple(series) + (bundle(fin),)

            def warm(prec, mean_temp, etp, frac_ice, frac_solid, state,
                     params):
                qsim, G, eTG, s_store, r_store, icemelt, fin = (
                    run_cemaneigegr4j_warm(
                        prec, mean_temp, etp, frac_solid,
                        ((state.snow.g, state.snow.etg), state.gr4j),
                        state.snow.g_thresh, params, num_uh1, num_uh2,
                        frac_ice=frac_ice))
                return (qsim, G, eTG, s_store, r_store, icemelt,
                        rebundle(fin[0], fin[1], state.snow))
        elif hyst and not ice:
            def cold(prec, mean_temp, etp, frac_solid, sp, ts, sca, s, r,
                     params):
                *series, fin = run_cemaneigehystgr4j(
                    prec, mean_temp, etp, frac_solid, sp, ts, sca, s, r,
                    params, num_uh1, num_uh2, return_final=True)
                return tuple(series) + (bundle(fin),)

            def warm(prec, mean_temp, etp, frac_solid, state, params):
                qsim, G, eTG, s_store, r_store, sca, rain, _, fin = (
                    run_cemaneigehystgr4j_warm(
                        prec, mean_temp, etp, frac_solid,
                        ((state.snow.g, state.snow.etg, state.snow.sca,
                          state.snow.swe_max), state.gr4j),
                        state.snow.psol_annual, params, num_uh1,
                        num_uh2))
                return (qsim, G, eTG, s_store, r_store, sca, rain,
                        rebundle(fin[0], fin[1], state.snow))
        else:
            def cold(prec, mean_temp, etp, frac_ice, frac_solid, sp, ts,
                     sca, s, r, params):
                *series, fin = run_cemaneigehystgr4jice(
                    prec, mean_temp, etp, frac_ice, frac_solid, sp, ts,
                    sca, s, r, params, num_uh1, num_uh2,
                    return_final=True)
                return tuple(series) + (bundle(fin),)

            def warm(prec, mean_temp, etp, frac_ice, frac_solid, state,
                     params):
                # Composed from the stage kernels (rather than the
                # composition warm op) because the class contract also
                # returns the snow-routine outflow series
                # (``cemaneigehystgr4jice_model.py:88-104``).
                snowmelt, G, eTG, sca, rain, snow_fin = (
                    run_cemaneigehyst_warm(
                        prec, mean_temp, frac_solid,
                        (state.snow.g, state.snow.etg, state.snow.sca,
                         state.snow.swe_max), state.snow.psol_annual,
                        params))
                icemelt = _weighted_icemelt(mean_temp, G, frac_ice,
                                            params)
                qsim, s_store, r_store, gr4j_fin = run_gr4j_warm(
                    snowmelt + icemelt, etp, state.gr4j, params, num_uh1,
                    num_uh2)
                return (qsim, G, eTG, s_store, r_store, sca, icemelt,
                        snowmelt, rain,
                        rebundle(snow_fin, gr4j_fin, state.snow))

        return cold, warm

    def _simulate_stateful(self, *, hyst, ice, num_uh1, num_uh2,
                           param_dict, initial_state, return_final_state,
                           return_storage, prec, mean_temp, etp,
                           frac_solid_prec, inits, frac_ice=None,
                           mesh=None, engine="xla", interpret=False):
        """Forecast-mode execution shared by the four composition classes.

        Args:
            inits: cold-start scalars in kernel order (snow_pack,
                thermal_state[, sca], s, r); must all be zero when
                ``initial_state`` is given (the caller validates).
        """
        from ..config import default_float

        num = param_dict['CTG'].shape[0]
        state = None
        if initial_state is not None:
            snow_cls = CemaneigeHystState if hyst else CemaneigeState
            check_state_type(initial_state, SnowGR4JState,
                             type(self).__name__, snow_cls=snow_cls)
            state = normalize_state(initial_state, num, default_float())
            if state.snow.g.shape[-1] != prec.shape[1]:
                raise ValueError(
                    f"initial_state carries {state.snow.g.shape[-1]} "
                    f"elevation layer(s) but the forcing resolves to "
                    f"{prec.shape[1]}; altitudes/met setup must match the "
                    "run that produced the state.")
            from .gr4j import GR4J
            GR4J._check_history_depth(state.gr4j.pr_history.shape[-1],
                                      num_uh2, param_dict['x4'])
        if engine == "pallas":
            from ..ops.pallas_snow import snowgr4j_simulate_pallas_state

            if hyst:
                sp, ts, _sca, s_i, r_i = inits  # sca_init is inert
                # (reference quirk, ops/cemaneige.py:run_cemaneigehyst)
            else:
                sp, ts, s_i, r_i = inits
            qsim_nt, final = snowgr4j_simulate_pallas_state(
                prec, mean_temp, etp, frac_solid_prec, param_dict,
                state=state, snow_pack_init=sp, thermal_state_init=ts,
                s_init=s_i, r_init=r_i, frac_ice=frac_ice, hyst=hyst,
                ice=ice, num_uh1=num_uh1, num_uh2=num_uh2,
                interpret=interpret)
            qsim = np.moveaxis(np.asarray(qsim_nt), 0, -1)
            out = (qsim,)
            if return_final_state:
                out = out + (final,)
            return out if len(out) > 1 else out[0]
        cold_kernel, warm_kernel = self._stateful_kernels(
            hyst, ice, num_uh1, num_uh2)
        fi = (frac_ice,) if ice else ()
        if state is None:
            series, final = self._run_batched_final(
                cold_kernel,
                (prec, mean_temp, etp) + fi + (frac_solid_prec,)
                + tuple(inits),
                param_dict, mesh=mesh)
        else:
            series, final = self._run_batched_final(
                warm_kernel,
                (prec, mean_temp, etp) + fi + (frac_solid_prec,),
                param_dict, state=state, mesh=mesh)
        out = series if return_storage else series[:1]
        if return_final_state:
            out = out + (final,)
        return out if len(out) > 1 else out[0]

    def _warm_cycle_pieces_snow(self, forcings, sim_kwargs, hyst, ice):
        """(time_arrays, warm_step) for device-resident assimilation
        cycling: the met preprocessing (elevation-layer extrapolation +
        solid fraction) runs ONCE over the full series host-side; the
        returned vmapped warm step advances one forcing window from a
        carried :class:`~rrmpg_jax.models.states.SnowGR4JState`."""
        import jax
        import jax.numpy as jnp

        from ..ops.uh import required_uh_lengths

        kw = dict(sim_kwargs)
        met_station_height = kw.pop('met_station_height', None)
        altitudes = kw.pop('altitudes', [])
        frac_ice = kw.pop('frac_ice', None)
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for {type(self).__name__} "
                f"cycling: {sorted(kw)}.")
        if ice and frac_ice is None:
            raise ValueError(
                f"{type(self).__name__} cycling needs 'frac_ice'.")
        prec, mean_temp, frac_solid, _, (etp,) = self._validate_met(
            forcings['prec'], forcings['mean_temp'],
            forcings['min_temp'], forcings['max_temp'],
            met_station_height, altitudes,
            extra_series=(('etp', forcings['etp']),))
        prec, mean_temp, etp, frac_solid = self._coerce_forcings(
            (prec, mean_temp, etp, frac_solid))
        n1, n2 = required_uh_lengths(self._default_bounds['x4'][1])
        _, warm = self._stateful_kernels(hyst, ice, n1, n2)
        fi = (None if frac_ice is None
              else jnp.asarray(self._validate_frac_ice(frac_ice),
                               etp.dtype))
        n_shared = 4 + (1 if ice else 0)
        vk = jax.vmap(warm, in_axes=(None,) * n_shared + (0, 0))

        def warm_step(arrays, state, params):
            prec_w, mt_w, etp_w, fs_w = arrays
            args = (prec_w, mt_w, etp_w)
            if ice:
                args = args + (fi,)
            out = vk(*(args + (fs_w,)), state, params)
            return out[0], out[-1]

        return (prec, mean_temp, etp, frac_solid), warm_step

    def _warm_point_kernel(self, hyst, ice, initial_state, num_layers,
                           engine):
        """Validate/collapse a fit ``initial_state`` and return
        ``(state, warm_kernel)`` for point-objective calibration."""
        from ..config import default_float
        from ..ops.uh import required_uh_lengths
        from .states import single_member_state

        snow_cls = CemaneigeHystState if hyst else CemaneigeState
        check_state_type(initial_state, SnowGR4JState,
                         type(self).__name__, snow_cls=snow_cls)
        state = single_member_state(initial_state, default_float())
        if state.snow.g.shape[-1] != num_layers:
            raise ValueError(
                f"initial_state carries {state.snow.g.shape[-1]} "
                f"elevation layer(s) but the forcing resolves to "
                f"{num_layers}; altitudes/met setup must match the run "
                "that produced the state.")
        n1, n2 = required_uh_lengths(self._default_bounds['x4'][1])
        _, warm = self._stateful_kernels(hyst, ice, n1, n2)
        return state, warm

    def _warm_fit_de(self, *, hyst, ice, engine, initial_state, prec,
                     mean_temp, etp, frac_solid_prec, obs, loss, seed,
                     de_kwargs, frac_ice=None, ndsi=None,
                     loss_metric=None, interpret=False):
        """Shared fit/fit_Q_SCA path from a carried state (warm objective).

        Builds the point objective on the warm composition kernel and runs
        the DE; with ``ndsi`` given, adds the reference's 0.75 / 5 x 0.05
        discharge+SCA weighting (``cemaneigehystgr4j.py:663-689``).

        With ``engine='pallas'`` (discharge-only objectives) every DE
        generation evaluates through the fused warm kernel instead: the
        one shared initial condition broadcasts across the candidate
        batch and enters the kernel's state
        (:func:`~rrmpg_jax.ops.pallas_snow.snowgr4j_ensemble_mse_pallas`
        with ``state=``).
        """
        import jax.numpy as jnp

        from ..tools.calibration import minimize

        if engine == "pallas":
            if ndsi is not None:
                raise ValueError(
                    "fit_Q_SCA(initial_state=) supports engine='xla' "
                    "only; the fused warm kernel covers the discharge "
                    "objectives.")
            return self._warm_fit_de_pallas(
                hyst=hyst, ice=ice, initial_state=initial_state,
                prec=prec, mean_temp=mean_temp, etp=etp,
                frac_solid_prec=frac_solid_prec, obs=obs,
                loss_metric=loss_metric, seed=seed, de_kwargs=de_kwargs,
                frac_ice=frac_ice, interpret=interpret)
        if engine != "xla":
            raise ValueError("engine must be 'xla' or 'pallas'.")
        state, warm = self._warm_point_kernel(hyst, ice, initial_state,
                                              prec.shape[1], engine)
        fi = (frac_ice,) if ice else ()
        args = tuple(jnp.asarray(a) for a in
                     (prec, mean_temp, etp) + fi + (frac_solid_prec,))
        obs_j = jnp.asarray(obs)
        names = self._param_list
        bounds = tuple(self._default_bounds[p] for p in names)
        ndsi_j = (None if ndsi is None
                  else jnp.stack([jnp.asarray(n) for n in ndsi]))  # (5, T)

        def objective(x):
            params = {name: x[i] for i, name in enumerate(names)}
            out = warm(*args, state, params)
            loss_q = loss(obs_j, out[0])
            if ndsi_j is None:
                return loss_q
            sca_bands = 100.0 * out[5].T  # (L, T)
            loss_sca = sum(loss(ndsi_j[b], sca_bands[b])
                           for b in range(5))
            return 0.75 * loss_q + 0.05 * loss_sca

        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)

    def _warm_fit_de_pallas(self, *, hyst, ice, initial_state, prec,
                            mean_temp, etp, frac_solid_prec, obs,
                            loss_metric, seed, de_kwargs, frac_ice=None,
                            interpret=False):
        """Fused warm recalibration: DE generations through the Pallas
        warm objective kernel (``state=`` entry)."""
        import jax.numpy as jnp

        from ..config import default_float
        from ..ops.pallas_snow import (
            losses_from_stats,
            snowgr4j_ensemble_mse_pallas,
        )
        from ..ops.uh import required_uh_lengths
        from ..tools.calibration import minimize
        from .states import single_member_state
        from .gr4j import GR4J

        if loss_metric not in ("mse", "rmse", "nse", "kge"):
            raise ValueError(
                f"Unsupported loss_metric {loss_metric!r}; "
                "supported: 'mse', 'rmse', 'nse', 'kge'.")
        use_stats = loss_metric in ("nse", "kge")

        snow_cls = CemaneigeHystState if hyst else CemaneigeState
        check_state_type(initial_state, SnowGR4JState,
                         type(self).__name__, snow_cls=snow_cls)
        state = single_member_state(initial_state, default_float())
        if state.snow.g.shape[-1] != prec.shape[1]:
            raise ValueError(
                f"initial_state carries {state.snow.g.shape[-1]} "
                f"elevation layer(s) but the forcing resolves to "
                f"{prec.shape[1]}; altitudes/met setup must match the "
                "run that produced the state.")
        x4_hi = self._default_bounds['x4'][1]
        # Short bounds-derived registers -- the same convention as the
        # cold fused fit (ceil-based; ~3% cheaper than the full 10/21
        # registers for the narrow-x4 classes, identical results).
        from .gr4j import fit_uh_lengths
        n1, n2 = fit_uh_lengths(x4_hi)
        GR4J._check_history_depth(state.gr4j.pr_history.shape[-1], n2,
                                  [x4_hi])

        args = tuple(jnp.asarray(a) for a in
                     (prec, mean_temp, etp, frac_solid_prec, obs))
        qobs_j = args[4]
        fi = None if frac_ice is None else jnp.asarray(frac_ice)
        names = self._param_list
        bounds = tuple(self._default_bounds[p] for p in names)
        # NaN observations = missing-data gaps -> masked kernel.
        masked = bool(np.isnan(np.asarray(obs)).any())

        def broadcast_state(P):
            import jax
            return jax.tree.map(
                lambda l: jnp.broadcast_to(l, (P,) + l.shape), state)

        def batch_objective(X):
            params = {name: X[:, i] for i, name in enumerate(names)}
            out = snowgr4j_ensemble_mse_pallas(
                *args, 0.0, 0.0, 0.0, 0.0, params, frac_ice=fi,
                hyst=hyst, ice=ice, stats=use_stats, num_uh1=n1,
                num_uh2=n2, interpret=interpret,
                state=broadcast_state(X.shape[0]), warm=True,
                masked=masked)
            if use_stats:
                return 1.0 - losses_from_stats(out, qobs_j)[loss_metric]
            if loss_metric == "rmse":
                return jnp.sqrt(out)
            return out

        return minimize(batch_objective, bounds, seed=seed,
                        batched=True, **de_kwargs)

    @staticmethod
    def _check_no_cold_inits(initial_state, inits, names):
        if initial_state is not None and any(v != 0 for v in inits):
            raise ValueError(
                "Pass either the cold-start init scalars "
                f"({', '.join(names)}) or a full initial_state (warm "
                "continuation), not both.")

    @staticmethod
    def _validate_frac_ice(frac_ice):
        """Validate the glacier-fraction array of the ice-melt variants.

        Reference semantics (``rrmpg/models/cemaneigegr4jice.py:200-208``):
        must be 1-D; coerced to a numpy array.
        """
        if isinstance(frac_ice, np.ndarray) and frac_ice.ndim != 1:
            raise ValueError(
                f"'frac_ice' needs one glaciated fraction per elevation "
                f"band (a flat array); got ndim={frac_ice.ndim}.")
        return np.asarray(frac_ice, dtype=np.float64)
