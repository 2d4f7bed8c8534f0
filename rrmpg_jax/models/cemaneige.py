"""Cemaneige snow-routine interface class (Valery 2010).

API-compatible with the reference ``Cemaneige``
(``rrmpg/models/cemaneige.py``): same parameters/bounds/dtype, simulate/fit
signatures, validation errors and output shapes ((T, N) outflow,
(T, L, N) storages).  The per-parameter-set loop
(``cemaneige.py:227``) is one batched device program here.
"""

import jax.numpy as jnp
import numpy as np

from ..ops.cemaneige import run_cemaneige, run_cemaneige_warm
from ..utils.array_checks import validate_array_input
from ._snow_base import CemaneigeBase
from .states import CemaneigeState, check_state_type, normalize_state


class Cemaneige(CemaneigeBase):
    """Interface to the Cemaneige snow accounting model."""

    _param_list = ['CTG', 'Kf']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (0, 10)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64)])

    def __init__(self, params=None):
        super().__init__(params=params)

    @staticmethod
    def _kernel(prec, mean_temp, frac_solid_prec, snow_pack_init,
                thermal_state_init, params):
        return run_cemaneige(prec, mean_temp, frac_solid_prec,
                             snow_pack_init, thermal_state_init, params)

    @staticmethod
    def _kernel_final(prec, mean_temp, frac_solid_prec, snow_pack_init,
                      thermal_state_init, params):
        outflow, G, eTG, fin = run_cemaneige(
            prec, mean_temp, frac_solid_prec, snow_pack_init,
            thermal_state_init, params, return_final=True)
        return outflow, G, eTG, CemaneigeState(*fin)

    @staticmethod
    def _warm_kernel(prec, mean_temp, frac_solid_prec, state, params):
        outflow, G, eTG, fin = run_cemaneige_warm(
            prec, mean_temp, frac_solid_prec, (state.g, state.etg),
            state.g_thresh, params)
        return outflow, G, eTG, CemaneigeState(fin[0], fin[1],
                                               state.g_thresh)

    def simulate(self, prec, mean_temp, min_temp, max_temp,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 altitudes=[], return_storages=False, params=None,
                 mesh=None, engine="xla", interpret=False,
                 initial_state=None, return_final_state=False):
        """Simulate the Cemaneige snow routine.

        Args:
            prec: (T,) daily precipitation sum [mm].
            mean_temp, min_temp, max_temp: (T,) daily temperatures [C].
            met_station_height: station elevation [m].
            snow_pack_init: (optional) initial snow pack storage.
            thermal_state_init: (optional) initial snowpack thermal state.
            altitudes: (optional) list of median layer elevations [m]; if
                given, forcings are extrapolated per elevation layer.
            return_storages: also return snowpack G and thermal state eTG.
            params: (optional) structured array / dict of parameter sets.
            mesh: (optional) device mesh to shard the ensemble over.
            engine: 'xla' (scan) or 'pallas' (fused ensemble kernel,
                outflow only).
            interpret: run the pallas engine in interpreter mode (CPU CI).
            initial_state: (optional)
                :class:`~rrmpg_jax.models.states.CemaneigeState` from a
                previous ``return_final_state=True`` call; continues that
                simulation (per-layer snow pack, thermal state and the
                original series' snow-cover threshold carried across the
                boundary).  Mutually exclusive with non-zero ``*_init``
                scalars.
            return_final_state: also return the end-of-series
                :class:`~rrmpg_jax.models.states.CemaneigeState` (member
                axis leading), accepted back via ``initial_state=``.

        Returns:
            outflow (T, N); plus G (T, L, N) and eTG (T, L, N) if
            ``return_storages``; plus the final state if
            ``return_final_state``.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
            RuntimeError: If there is a size mismatch between
                meteorological input arrays.
        """
        prec, mean_temp, frac_solid_prec, _, _ = self._validate_met(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes)
        snow_pack_init = self._validate_number(snow_pack_init,
                                               'snow_pack_init')
        thermal_state_init = self._validate_number(thermal_state_init,
                                                   'thermal_state_init')
        self._check_no_cold_inits(
            initial_state, (snow_pack_init, thermal_state_init),
            ('snow_pack_init', 'thermal_state_init'))

        param_dict, _ = self._prepare_params(params)
        if initial_state is not None or return_final_state:
            self._check_stateful_supported(engine, mesh)
            from ..config import default_float
            if initial_state is None:
                series, final = self._run_batched_final(
                    self._kernel_final,
                    (prec, mean_temp, frac_solid_prec, snow_pack_init,
                     thermal_state_init), param_dict, mesh=mesh)
            else:
                check_state_type(initial_state, CemaneigeState,
                                 type(self).__name__)
                num = param_dict['CTG'].shape[0]
                state = normalize_state(initial_state, num,
                                        default_float())
                if state.g.shape[-1] != prec.shape[1]:
                    raise ValueError(
                        f"initial_state carries {state.g.shape[-1]} "
                        "elevation layer(s) but the forcing resolves to "
                        f"{prec.shape[1]}; altitudes/met setup must match "
                        "the run that produced the state.")
                series, final = self._run_batched_final(
                    self._warm_kernel,
                    (prec, mean_temp, frac_solid_prec), param_dict,
                    state=state, mesh=mesh)
            out = series if return_storages else series[:1]
            if return_final_state:
                out = out + (final,)
            return out if len(out) > 1 else out[0]
        if engine == "pallas":
            if mesh is not None:
                raise ValueError(
                    "engine='pallas' simulate runs single-device through "
                    "the class API and would silently ignore mesh; use "
                    "engine='xla' for sharded simulation, or the "
                    "regional/ensemble helpers in rrmpg_jax.parallel.")
            if return_storages:
                raise ValueError(
                    "engine='pallas' computes the outflow only; use "
                    "engine='xla' for storage trajectories.")
            from ..ops.pallas_snow import cemaneige_simulate_pallas
            outflow = cemaneige_simulate_pallas(
                prec, mean_temp, frac_solid_prec, snow_pack_init,
                thermal_state_init, param_dict, interpret=interpret)
            return np.moveaxis(np.asarray(outflow), 0, -1)
        if engine != "xla":
            raise ValueError(
                f"Unsupported engine {engine!r}; use 'xla' or 'pallas'.")
        outflow, G, eTG = self._run_batched(
            self._kernel,
            (prec, mean_temp, frac_solid_prec, snow_pack_init,
             thermal_state_init),
            param_dict, mesh=mesh)
        if return_storages:
            return outflow, G, eTG
        return outflow

    def fit(self, obs, prec, mean_temp, min_temp, max_temp,
            met_station_height, snow_pack_init=0, thermal_state_init=0,
            altitudes=[], loss_metric="mse", seed=None, engine="xla",
            interpret=False, initial_state=None, **de_kwargs):
        """Calibrate CTG/Kf on an observed outflow series (device DE).

        Args:
            loss_metric: calibration loss -- 'mse' (default),
                'rmse', or 'nse'/'kge' minimizing ``1 - score``
                (both engines; the fused kernel accumulates the
                sufficient statistics on-device for nse/kge).
            engine: 'xla', or 'pallas' to evaluate each DE generation with
                the fused snow-only ensemble kernel.
            initial_state: (optional) single-member
                :class:`~rrmpg_jax.models.states.CemaneigeState` --
                calibrate a continuation segment from a known initial
                condition (``engine='xla'`` only).

        Returns:
            An :class:`~rrmpg_jax.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize
        from ..utils.metrics import calibration_loss

        loss = calibration_loss(loss_metric)
        obs = validate_array_input(obs, np.float64, 'obs')
        prec, mean_temp, frac_solid_prec, _, _ = self._validate_met(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes)
        snow_pack_init = self._validate_number(snow_pack_init,
                                               'snow_pack_init')
        thermal_state_init = self._validate_number(thermal_state_init,
                                                   'thermal_state_init')
        self._check_no_cold_inits(
            initial_state, (snow_pack_init, thermal_state_init),
            ('snow_pack_init', 'thermal_state_init'))

        prec_j = jnp.asarray(prec)
        mean_temp_j = jnp.asarray(mean_temp)
        frac_j = jnp.asarray(frac_solid_prec)
        obs_j = jnp.asarray(obs)
        bounds = tuple(self._default_bounds[p] for p in self._param_list)

        if initial_state is not None:
            from ..config import default_float
            from .states import single_member_state

            if engine != "xla":
                raise ValueError(
                    "fit(initial_state=) supports engine='xla' only.")
            check_state_type(initial_state, CemaneigeState,
                             type(self).__name__)
            state = single_member_state(initial_state, default_float())
            if state.g.shape[-1] != prec.shape[1]:
                raise ValueError(
                    f"initial_state carries {state.g.shape[-1]} elevation "
                    f"layer(s) but the forcing resolves to "
                    f"{prec.shape[1]}; altitudes/met setup must match the "
                    "run that produced the state.")

            def objective(x):
                params = {'CTG': x[0], 'Kf': x[1]}
                outflow, _, _, _ = run_cemaneige_warm(
                    prec_j, mean_temp_j, frac_j, (state.g, state.etg),
                    state.g_thresh, params)
                return loss(obs_j, outflow)

            return minimize(objective, bounds, seed=seed,
                                          **de_kwargs)

        if engine == "pallas":
            from ..ops.pallas_snow import (
                cemaneige_ensemble_mse_pallas,
                losses_from_stats,
            )

            use_stats = loss_metric in ("nse", "kge")
            # NaN observations = missing-data gaps -> masked kernel.
            masked = bool(np.isnan(np.asarray(obs)).any())

            def batch_objective(X):
                params = {'CTG': X[:, 0], 'Kf': X[:, 1]}
                out = cemaneige_ensemble_mse_pallas(
                    prec_j, mean_temp_j, frac_j, obs_j, snow_pack_init,
                    thermal_state_init, params, interpret=interpret,
                    stats=use_stats, masked=masked)
                if use_stats:
                    return 1.0 - losses_from_stats(out,
                                                   obs_j)[loss_metric]
                if loss_metric == "rmse":
                    return jnp.sqrt(out)
                return out

            return minimize(batch_objective, bounds,
                                          seed=seed, batched=True,
                                          **de_kwargs)
        if engine != "xla":
            raise ValueError(
                f"Unsupported engine {engine!r}; use 'xla' or 'pallas'.")

        def objective(x):
            params = {'CTG': x[0], 'Kf': x[1]}
            outflow, _, _ = run_cemaneige(
                prec_j, mean_temp_j, frac_j, snow_pack_init,
                thermal_state_init, params)
            return loss(obs_j, outflow)

        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)
