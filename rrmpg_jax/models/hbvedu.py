"""HBV-Edu interface class (Aghakouchak & Habib 2010).

API-compatible with the reference ``HBVEdu`` (``rrmpg/models/hbvedu.py``):
same 11 parameters/bounds/dtype, same simulate/fit signatures and
validation errors (month array in [1, 12], monthly climatologies of
length 12).  The per-parameter-set loop of the reference
(``hbvedu.py:199``) is one batched device program here.
"""

import jax.numpy as jnp
import numpy as np

from ..ops.hbvedu import run_hbvedu, run_hbvedu_warm
from ..utils.array_checks import check_for_negatives, validate_array_input
from .basemodel import BaseModel
from .states import HBVEduState, check_state_type, normalize_state


class HBVEdu(BaseModel):
    """Interface to the educational HBV model."""

    _param_list = ['T_t', 'DD', 'FC', 'Beta', 'C', 'PWP', 'K_0', 'K_1',
                   'K_2', 'K_p', 'L']

    _default_bounds = {'T_t': (-1, 1),
                       'DD': (3, 7),
                       'FC': (100, 200),
                       'Beta': (1, 7),
                       'C': (0.01, 0.07),
                       'PWP': (90, 180),
                       'K_0': (0.05, 0.2),
                       'K_1': (0.01, 0.1),
                       'K_2': (0.01, 0.05),
                       'K_p': (0.01, 0.05),
                       'L': (2, 5)}

    _dtype = np.dtype([('T_t', np.float64),
                       ('DD', np.float64),
                       ('FC', np.float64),
                       ('Beta', np.float64),
                       ('C', np.float64),
                       ('PWP', np.float64),
                       ('K_0', np.float64),
                       ('K_1', np.float64),
                       ('K_2', np.float64),
                       ('K_p', np.float64),
                       ('L', np.float64)])

    def __init__(self, params=None):
        """Initialize an HBV-Edu model object.

        Args:
            params: (optional) parameter dict; random within default bounds
                if omitted.
        """
        super().__init__(params=params)

    @staticmethod
    def _kernel(temp, prec, month, pe_m, t_m, snow_init, soil_init, s1_init,
                s2_init, params):
        return run_hbvedu(temp, prec, month, pe_m, t_m, snow_init, soil_init,
                          s1_init, s2_init, params)

    @staticmethod
    def _kernel_final(temp, prec, month, pe_m, t_m, snow_init, soil_init,
                      s1_init, s2_init, params):
        *series, final = run_hbvedu(
            temp, prec, month, pe_m, t_m, snow_init, soil_init, s1_init,
            s2_init, params, return_final=True)
        return tuple(series) + (HBVEduState(*final),)

    @staticmethod
    def _warm_kernel(temp, prec, month, pe_m, t_m, state, params):
        *series, final = run_hbvedu_warm(temp, prec, month, pe_m, t_m,
                                         tuple(state), params)
        return tuple(series) + (HBVEduState(*final),)

    @classmethod
    def _validate_inputs(cls, temp, prec, month, PE_m, T_m):
        temp = validate_array_input(temp, np.float64, 'temperature')
        prec = validate_array_input(prec, np.float64, 'precipitation')
        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")

        month = validate_array_input(month, np.int8, 'month')
        if any(len(arr) != len(temp) for arr in [prec, month]):
            raise RuntimeError(
                "temp, prec and month series need matching lengths; got "
                f"{len(temp)}, {len(prec)} and {len(month)}.")

        PE_m = validate_array_input(PE_m, np.float64, 'PE_m')
        T_m = validate_array_input(T_m, np.float64, 'T_m')
        if any(len(arr) != 12 for arr in [PE_m, T_m]):
            raise RuntimeError(
                "PE_m and T_m are monthly climatologies and need exactly 12 "
                f"entries; got {len(PE_m)} and {len(T_m)}.")

        if (np.min(month) < 1) or (np.max(month) > 12):
            raise ValueError(
                "Month indices must be integers from 1 (January) through "
                "12 (December).")

        # 0-based month index for the climatology gather.
        month = (month - 1).astype(np.int32)
        return temp, prec, month, PE_m, T_m

    def simulate(self, temp, prec, month, PE_m, T_m, snow_init=0,
                 soil_init=0, s1_init=0, s2_init=0, return_storage=False,
                 params=None, mesh=None, engine="xla", interpret=False,
                 initial_state=None, return_final_state=False):
        """Simulate rainfall-runoff for the given forcings.

        Args:
            temp: (T,) mean temperature series.
            prec: (T,) precipitation series.
            month: (T,) month number of each timestep in [1, 12].
            PE_m: (12,) long-term monthly potential evapotranspiration.
            T_m: (12,) long-term monthly mean temperature.
            snow_init, soil_init, s1_init, s2_init: initial storages.
            return_storage: also return the four storage series.
            params: (optional) structured array / dict of parameter sets.
            mesh: (optional) device mesh to shard the ensemble over.
            engine: 'xla' (scan) or 'pallas' (fused ensemble kernel,
                discharge only; forecast mode -- ``initial_state`` /
                ``return_final_state`` -- carries the storages in
                registers, single-device).
            interpret: run the pallas engine in interpreter mode (CPU CI).
            initial_state: (optional)
                :class:`~rrmpg_jax.models.states.HBVEduState` from a
                previous ``return_final_state=True`` call; continues that
                simulation (every timestep advances the carried storages,
                vs the reference's t=0 init step).  Mutually exclusive
                with non-zero ``*_init`` scalars.
            return_final_state: also return the end-of-series
                :class:`~rrmpg_jax.models.states.HBVEduState` (member
                axis leading), accepted back via ``initial_state=``.

        Returns:
            qsim (T, N); plus snow, soil, s1, s2 (each (T, N)) if
            ``return_storage``; plus the final state if
            ``return_final_state``.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
            RuntimeError: If the monthly arrays are not of size 12 or there
                is a size mismatch between precipitation, temperature and
                the month array.
        """
        temp, prec, month, PE_m, T_m = self._validate_inputs(
            temp, prec, month, PE_m, T_m)
        snow_init = float(snow_init)
        soil_init = float(soil_init)
        s1_init = float(s1_init)
        s2_init = float(s2_init)
        if not isinstance(return_storage, bool):
            raise TypeError(
                "'return_storage' expects a bool, got "
                f"{type(return_storage).__name__}.")
        if initial_state is not None:
            check_state_type(initial_state, HBVEduState,
                             type(self).__name__)
            if any(v != 0 for v in (snow_init, soil_init, s1_init,
                                    s2_init)):
                raise ValueError(
                    "Pass either the *_init scalars (cold start) or a "
                    "full initial_state (warm continuation), not both.")

        param_dict, _ = self._prepare_params(params)
        if initial_state is not None or return_final_state:
            self._check_stateful_engine(engine, mesh, return_storage)
            from ..config import default_float
            if engine == "pallas":
                # Fused forecast mode: state entry/exit in the kernel,
                # discharge-only, single-device (guards above).
                from ..ops.pallas_hbv import hbv_simulate_pallas_state

                state = None
                if initial_state is not None:
                    num = param_dict['T_t'].shape[0]
                    state = normalize_state(initial_state, num,
                                            default_float())
                qsim, final = hbv_simulate_pallas_state(
                    temp, prec, month, PE_m, T_m, snow_init, soil_init,
                    s1_init, s2_init, param_dict, interpret=interpret,
                    state=state)
                out = np.moveaxis(np.asarray(qsim), 0, -1)
                if return_final_state:
                    return out, final
                return out
            if initial_state is None:
                series, final = self._run_batched_final(
                    self._kernel_final,
                    (temp, prec, month, PE_m, T_m, snow_init, soil_init,
                     s1_init, s2_init), param_dict, mesh=mesh)
            else:
                num = param_dict['T_t'].shape[0]
                state = normalize_state(initial_state, num,
                                        default_float())
                series, final = self._run_batched_final(
                    self._warm_kernel, (temp, prec, month, PE_m, T_m),
                    param_dict, state=state, mesh=mesh)
            out = series if return_storage else series[:1]
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
            if return_storage:
                raise ValueError(
                    "engine='pallas' computes discharge only; use "
                    "engine='xla' for storage trajectories.")
            from ..ops.pallas_hbv import hbv_simulate_pallas
            qsim = hbv_simulate_pallas(
                temp, prec, month, PE_m, T_m, snow_init, soil_init,
                s1_init, s2_init, param_dict, interpret=interpret)
            return np.moveaxis(np.asarray(qsim), 0, -1)
        if engine != "xla":
            raise ValueError(
                f"Unsupported engine {engine!r}; use 'xla' or 'pallas'.")
        outputs = self._run_batched(
            self._kernel,
            (temp, prec, month, PE_m, T_m, snow_init, soil_init, s1_init,
             s2_init),
            param_dict, mesh=mesh)
        if return_storage:
            return outputs
        return outputs[0]

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """Device-resident cycling pieces (see GR4J._warm_cycle_pieces).

        ``PE_m``/``T_m`` (the (12,) monthly climatologies) ride in
        ``sim_kwargs`` -- they are window-independent constants.
        """
        import jax
        import jax.numpy as jnp

        kw = dict(sim_kwargs)
        pe_m = kw.pop('PE_m')
        t_m = kw.pop('T_m')
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for HBVEdu cycling: "
                f"{sorted(kw)}.")
        temp = validate_array_input(forcings['temp'], np.float64, 'temp')
        prec = validate_array_input(forcings['prec'], np.float64, 'prec')
        month = np.asarray(forcings['month'])
        temp, prec = self._coerce_forcings((temp, prec))
        pe_m, t_m = self._coerce_forcings(
            (np.asarray(pe_m, np.float64), np.asarray(t_m, np.float64)))
        month = jnp.asarray(month)
        vk = jax.vmap(self._warm_kernel,
                      in_axes=(None, None, None, None, None, 0, 0))

        def warm_step(arrays, state, params):
            temp_w, prec_w, month_w = arrays
            out = vk(temp_w, prec_w, month_w, pe_m, t_m, state, params)
            return out[0], out[-1]

        return (temp, prec, month), warm_step

    def _fused_stats(self, qobs, param_dict, sim_kwargs):
        """(4, N) time-mean sufficient statistics of the fused objective
        kernel (see ``GR4J._fused_stats``): the trajectory-free
        evaluation behind ``monte_carlo(return_qsim=False,
        engine='pallas')``."""
        import jax.numpy as jnp

        from ..ops.pallas_hbv import hbv_ensemble_mse_pallas

        kw = dict(sim_kwargs)
        kw.pop("engine", None)
        interpret = kw.pop("interpret", False)
        if kw.pop("mesh", None) is not None:
            raise ValueError(
                "The fused statistics path runs single-device; drop "
                "mesh= (shard with parallel.ensemble instead) or keep "
                "return_qsim=True.")
        temp = kw.pop("temp")
        prec = kw.pop("prec")
        month = kw.pop("month")
        PE_m = kw.pop("PE_m")
        T_m = kw.pop("T_m")
        inits = tuple(float(kw.pop(k, 0.0)) for k in
                      ("snow_init", "soil_init", "s1_init", "s2_init"))
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for the fused statistics "
                f"path: {sorted(kw)}.")
        temp, prec, month, PE_m, T_m = self._validate_inputs(
            temp, prec, month, PE_m, T_m)
        return hbv_ensemble_mse_pallas(
            jnp.asarray(temp), jnp.asarray(prec), month,
            jnp.asarray(PE_m), jnp.asarray(T_m), jnp.asarray(qobs),
            *inits, {k: jnp.asarray(v) for k, v in param_dict.items()},
            interpret=interpret, stats=True,
            masked=bool(np.isnan(np.asarray(qobs)).any()))

    def fit(self, qobs, temp, prec, month, PE_m, T_m, snow_init=0.,
            soil_init=0., s1_init=0., s2_init=0., loss_metric="mse",
            seed=None, engine="xla", interpret=False,
            initial_state=None, **de_kwargs):
        """Calibrate the model on observed discharge (device-resident DE).

        Args:
            loss_metric: calibration loss -- 'mse' (default),
                'rmse', or 'nse'/'kge' minimizing ``1 - score``
                (both engines; the fused kernel accumulates the
                sufficient statistics on-device for nse/kge).
            engine: 'xla', or 'pallas' to evaluate each DE generation with
                the fused ensemble kernel.
            initial_state: (optional) single-member
                :class:`~rrmpg_jax.models.states.HBVEduState` -- calibrate
                a continuation segment from a known initial condition.
                Works on both engines (the fused kernel enters the
                carried storages); mutually exclusive with
                non-zero ``*_init`` scalars.

        Returns:
            An :class:`~rrmpg_jax.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize
        from ..utils.metrics import calibration_loss

        loss = calibration_loss(loss_metric)
        qobs = validate_array_input(qobs, np.float64, 'qobs')
        temp, prec, month, PE_m, T_m = self._validate_inputs(
            temp, prec, month, PE_m, T_m)

        inits = tuple(float(v) for v in (snow_init, soil_init, s1_init,
                                         s2_init))
        temp_j, prec_j = jnp.asarray(temp), jnp.asarray(prec)
        month_j = jnp.asarray(month)
        pe_m_j, t_m_j = jnp.asarray(PE_m), jnp.asarray(T_m)
        qobs_j = jnp.asarray(qobs)
        names = self._param_list
        bounds = tuple(self._default_bounds[p] for p in self._param_list)

        if initial_state is not None:
            from ..config import default_float
            from .states import single_member_state

            check_state_type(initial_state, HBVEduState,
                             type(self).__name__)
            if any(v != 0 for v in inits):
                raise ValueError(
                    "Pass either the *_init scalars (cold start) or a "
                    "full initial_state (warm calibration), not both.")
            state = single_member_state(initial_state, default_float())

            if engine == "pallas":
                # Fused warm recalibration: the shared carried storages
                # broadcast to every DE candidate inside the kernel.
                from ..ops.pallas_hbv import hbv_ensemble_mse_pallas
                from ..ops.pallas_snow import losses_from_stats

                use_stats = loss_metric in ("nse", "kge")
                masked = bool(np.isnan(qobs).any())

                def batch_objective(X):
                    params = {name: X[:, i]
                              for i, name in enumerate(names)}
                    out = hbv_ensemble_mse_pallas(
                        temp_j, prec_j, month_j, pe_m_j, t_m_j, qobs_j,
                        0.0, 0.0, 0.0, 0.0, params, interpret=interpret,
                        stats=use_stats, masked=masked, state=state,
                        warm=True)
                    if use_stats:
                        return 1.0 - losses_from_stats(
                            out, qobs_j)[loss_metric]
                    if loss_metric == "rmse":
                        return jnp.sqrt(out)
                    return out

                return minimize(batch_objective, bounds, seed=seed,
                                batched=True, **de_kwargs)
            if engine != "xla":
                raise ValueError("engine must be 'xla' or 'pallas'.")

            def objective(x):
                params = {name: x[i] for i, name in enumerate(names)}
                qsim, *_ = run_hbvedu_warm(temp_j, prec_j, month_j,
                                           pe_m_j, t_m_j, tuple(state),
                                           params)
                return loss(qobs_j, qsim)

            return minimize(objective, bounds, seed=seed,
                                          **de_kwargs)

        if engine == "pallas":
            from ..ops.pallas_hbv import hbv_ensemble_mse_pallas
            from ..ops.pallas_snow import losses_from_stats

            use_stats = loss_metric in ("nse", "kge")
            # NaN observations = missing-data gaps -> masked kernel.
            masked = bool(np.isnan(qobs).any())

            def batch_objective(X):
                params = {name: X[:, i] for i, name in enumerate(names)}
                out = hbv_ensemble_mse_pallas(
                    temp_j, prec_j, month_j, pe_m_j, t_m_j, qobs_j,
                    *inits, params, interpret=interpret,
                    stats=use_stats, masked=masked)
                if use_stats:
                    return 1.0 - losses_from_stats(out,
                                                   qobs_j)[loss_metric]
                if loss_metric == "rmse":
                    return jnp.sqrt(out)
                return out

            return minimize(batch_objective, bounds,
                                          seed=seed, batched=True,
                                          **de_kwargs)
        if engine != "xla":
            raise ValueError("engine must be 'xla' or 'pallas'.")

        def objective(x):
            params = {name: x[i] for i, name in enumerate(names)}
            qsim, *_ = run_hbvedu(temp_j, prec_j, month_j, pe_m_j, t_m_j,
                                  *inits, params)
            return loss(qobs_j, qsim)

        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)
