"""GR4J interface class (Perrin, Michel & Andreassian 2003).

API-compatible with the reference ``GR4J`` (``rrmpg/models/gr4j.py``):
same parameters/bounds/dtype, same simulate/fit signatures and validation
errors.  Two deliberate behavioral fixes over the reference, both
documented divergences:

* the reference returns after simulating only the *first* parameter set
  when ``return_storage=False`` (``rrmpg/models/gr4j.py:176-178``); here
  all parameter sets are always simulated (batched, one device program).
* ``fit`` runs the device-resident differential evolution of
  :mod:`rrmpg_jax.tools.calibration` rather than scipy's serial one.
"""

import functools
import numbers

import jax.numpy as jnp
import numpy as np

from ..ops.gr4j import GR4JState, run_gr4j, run_gr4j_warm
from ..ops.uh import NUM_UH1, NUM_UH2, required_uh_lengths
from ..utils.array_checks import check_for_negatives, validate_array_input
from .basemodel import BaseModel
from .states import check_state_type, normalize_state


def fit_uh_lengths(x4_hi):
    """Short bounds-derived UH register lengths for the fused fit paths.

    ``ceil(x4_hi)`` / ``ceil(2*x4_hi + 1)`` taps cover every candidate
    within the class bounds (the reference sizes its buffers this way
    per run, ``gr4j_model.py:67-69``), capped at the full
    ``NUM_UH1``/``NUM_UH2`` registers.  The short registers are the
    intended calibration fast path -- the full (10, 21) registers cost
    only ~3% extra fused but the short ones are never wrong, so every
    fused fit branch (cold and warm, GR4J and the snow compositions)
    derives its lengths here.
    """
    n1 = min(int(np.ceil(x4_hi)), NUM_UH1)
    n2 = min(int(np.ceil(2.0 * x4_hi + 1.0)), NUM_UH2)
    return n1, n2


class GR4J(BaseModel):
    """Interface to the GR4J model."""

    _param_list = ['x1', 'x2', 'x3', 'x4']

    _default_bounds = {'x1': (100, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 300),
                       'x4': (1.1, 2.9)}

    _dtype = np.dtype([('x1', np.float64),
                       ('x2', np.float64),
                       ('x3', np.float64),
                       ('x4', np.float64)])

    def __init__(self, params=None):
        super().__init__(params=params)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _kernel_for(num_uh1, num_uh2, return_final=False):
        # UH register lengths are static under jit; sized from the actual
        # parameter batch so large x4 never truncates the hydrograph.
        def kernel(prec, etp, s_init, r_init, params):
            return run_gr4j(prec, etp, s_init, r_init, params, num_uh1,
                            num_uh2, return_final=return_final)
        return kernel

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _warm_kernel_for(num_uh1, num_uh2):
        def kernel(prec, etp, state, params):
            return run_gr4j_warm(prec, etp, state, params, num_uh1,
                                 num_uh2)
        return kernel

    @staticmethod
    def _validate_forcings(prec, etp):
        prec = validate_array_input(prec, np.float64, 'precipitation')
        etp = validate_array_input(etp, np.float64, 'pot. evapotranspiration')
        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")
        if len(prec) != len(etp):
            raise RuntimeError(
                f"prec and etp lengths differ: {len(prec)} vs {len(etp)}.")
        return prec, etp

    @staticmethod
    def _validate_inits(s_init, r_init):
        if not isinstance(s_init, numbers.Number):
            raise TypeError(
                f"'s_init' needs a numeric scalar, got {type(s_init).__name__}.")
        if not isinstance(r_init, numbers.Number):
            raise TypeError(
                f"'r_init' needs a numeric scalar, got {type(r_init).__name__}.")
        s_init = float(s_init)
        r_init = float(r_init)
        if not 0 <= s_init <= 1:
            raise ValueError(
                f"'s_init' is a fraction of x1 and must lie in [0, 1]; got "
                f"{s_init}.")
        if not 0 <= r_init <= 1:
            raise ValueError(
                f"'r_init' is a fraction of x3 and must lie in [0, 1]; got "
                f"{r_init}.")
        return s_init, r_init

    def simulate(self, prec, etp, s_init=0, r_init=0, return_storage=False,
                 params=None, mesh=None, engine="xla", interpret=False,
                 initial_state=None, return_final_state=False):
        """Simulate streamflow for the given forcings.

        Args:
            prec: (T,) precipitation [mm/day].
            etp: (T,) potential evapotranspiration [mm/day].
            s_init: initial production store filling as fraction of x1,
                in [0, 1].
            r_init: initial routing store filling as fraction of x3,
                in [0, 1].
            return_storage: also return the s/r store series.
            params: (optional) structured array / dict of parameter sets,
                evaluated batched in one device program.
            mesh: (optional) device mesh to shard the ensemble over.
            engine: 'xla' (scan/conv decomposition) or 'pallas' (fused
                ensemble kernel with the state in registers, discharge
                only).
            initial_state: (optional)
                :class:`~rrmpg_jax.ops.gr4j.GR4JState` from a previous
                ``return_final_state=True`` call; continues that
                simulation seamlessly (stores + UH filter history carried
                across the boundary).  Mutually exclusive with non-zero
                ``s_init``/``r_init``.
            return_final_state: also return the end-of-series
                :class:`~rrmpg_jax.ops.gr4j.GR4JState` (member axis
                leading), accepted back via ``initial_state=``.

        Returns:
            qsim (T, N), plus s_store (T, N) and r_store (T, N) if
            ``return_storage``, plus the final state if
            ``return_final_state``.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
            RuntimeError: If there is a size mismatch between the
                precipitation and the pot. evapotranspiration input.
        """
        prec, etp = self._validate_forcings(prec, etp)
        s_init, r_init = self._validate_inits(s_init, r_init)
        if not isinstance(return_storage, bool):
            raise TypeError(
                "'return_storage' expects a bool, got "
                f"{type(return_storage).__name__}.")
        if initial_state is not None:
            check_state_type(initial_state, GR4JState, type(self).__name__)
            if s_init != 0 or r_init != 0:
                raise ValueError(
                    "Pass either fractional s_init/r_init (cold start) or "
                    "a full initial_state (warm continuation), not both.")

        param_dict, _ = self._prepare_params(params)
        n1, n2 = required_uh_lengths(param_dict['x4'])
        if initial_state is not None or return_final_state:
            self._check_stateful_engine(engine, mesh, return_storage)
            return self._simulate_stateful(
                prec, etp, s_init, r_init, initial_state,
                return_final_state, return_storage, param_dict, n1, n2,
                mesh, engine=engine, interpret=interpret)
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
            from ..ops.pallas_gr4j import gr4j_simulate_pallas
            qsim = gr4j_simulate_pallas(prec, etp, s_init, r_init,
                                        param_dict, num_uh1=n1,
                                        num_uh2=n2, interpret=interpret)
            return np.moveaxis(np.asarray(qsim), 0, -1)
        if engine != "xla":
            raise ValueError("engine must be 'xla' or 'pallas'.")
        qsim, s_store, r_store = self._run_batched(
            self._kernel_for(n1, n2), (prec, etp, s_init, r_init),
            param_dict, mesh=mesh)
        if return_storage:
            return qsim, s_store, r_store
        return qsim

    @staticmethod
    def _check_history_depth(h_avail, num_uh2, x4_values):
        """Class-level guard: the carried UH history must cover the
        continuation's filter depth (an actionable rewording of the ops
        guard -- the class API exposes no ``num_uh2``)."""
        h_needed = num_uh2 - 1
        if h_avail < h_needed:
            import numpy as _np
            raise ValueError(
                f"initial_state carries {h_avail} unit-hydrograph history "
                f"taps but x4={float(_np.max(_np.asarray(x4_values))):g} "
                f"needs {h_needed}. The state was produced by a run with "
                "a smaller UH filter depth; produce it with return_final_"
                "state=True under parameters (or class bounds) whose x4 "
                "covers the continuation's, or keep the continuation x4 "
                "within the producing run's range.")

    def _simulate_stateful(self, prec, etp, s_init, r_init, initial_state,
                           return_final_state, return_storage, param_dict,
                           n1, n2, mesh=None, engine="xla",
                           interpret=False):
        """Forecast-mode execution: warm continuation and/or final state."""
        from ..config import default_float

        num = param_dict['x1'].shape[0]
        state = None
        if initial_state is not None:
            state = normalize_state(initial_state, num, default_float())
            self._check_history_depth(state.pr_history.shape[-1], n2,
                                      param_dict['x4'])
        if engine == "pallas":
            from ..ops.pallas_gr4j import gr4j_simulate_pallas_state

            qsim_nt, final = gr4j_simulate_pallas_state(
                prec, etp, param_dict, state=state, s_init=s_init,
                r_init=r_init, num_uh1=n1, num_uh2=n2,
                interpret=interpret)
            qsim = np.moveaxis(np.asarray(qsim_nt), 0, -1)
        elif state is None:
            (qsim, s_store, r_store), final = self._run_batched_final(
                self._kernel_for(n1, n2, return_final=True),
                (prec, etp, s_init, r_init), param_dict, mesh=mesh)
        else:
            (qsim, s_store, r_store), final = self._run_batched_final(
                self._warm_kernel_for(n1, n2), (prec, etp), param_dict,
                state=state, mesh=mesh)
        out = (qsim,)
        if return_storage:
            out = out + (s_store, r_store)
        if return_final_state:
            out = out + (final,)
        return out if len(out) > 1 else out[0]

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """(time_arrays, warm_step) for device-resident assimilation
        cycling (:func:`rrmpg_jax.tools.assimilation.assimilation_cycle`
        with ``backend='scan'``): validated full-series forcing arrays
        (leading time axis, windowed by the caller) and a vmapped warm
        step ``warm_step(window_arrays, state, params_dict) ->
        (qsim (N, w), new_state)``."""
        import jax

        if sim_kwargs:
            raise ValueError(
                f"GR4J.simulate takes no extra forcing kwargs; got "
                f"{sorted(sim_kwargs)}.")
        prec, etp = self._validate_forcings(forcings['prec'],
                                            forcings['etp'])
        prec, etp = self._coerce_forcings((prec, etp))
        n1, n2 = required_uh_lengths(self._default_bounds['x4'][1])
        kernel = self._warm_kernel_for(n1, n2)
        vk = jax.vmap(kernel, in_axes=(None, None, 0, 0))

        def warm_step(arrays, state, params):
            prec_w, etp_w = arrays
            qsim, _s, _r, final = vk(prec_w, etp_w, state, params)
            return qsim, final

        return (prec, etp), warm_step

    def _fused_stats(self, qobs, param_dict, sim_kwargs):
        """(4, N) time-mean sufficient statistics of the fused objective
        kernel -- the trajectory-free evaluation behind
        ``monte_carlo(return_qsim=False, engine='pallas')`` (four floats
        per member reach HBM; metrics via
        :func:`rrmpg_jax.ops.pallas_snow.losses_from_stats`)."""
        from ..ops.pallas_gr4j import gr4j_ensemble_mse_pallas

        kw = dict(sim_kwargs)
        kw.pop("engine", None)
        interpret = kw.pop("interpret", False)
        if kw.pop("mesh", None) is not None:
            raise ValueError(
                "The fused statistics path runs single-device; drop "
                "mesh= (shard with parallel.ensemble instead) or keep "
                "return_qsim=True.")
        prec = kw.pop("prec")
        etp = kw.pop("etp")
        s_init = kw.pop("s_init", 0.0)
        r_init = kw.pop("r_init", 0.0)
        if kw:
            raise ValueError(
                f"Unused simulate kwargs for the fused statistics "
                f"path: {sorted(kw)}.")
        prec, etp = self._validate_forcings(prec, etp)
        s_init, r_init = self._validate_inits(s_init, r_init)
        n1, n2 = required_uh_lengths(param_dict['x4'])
        return gr4j_ensemble_mse_pallas(
            jnp.asarray(prec), jnp.asarray(etp), jnp.asarray(qobs),
            s_init, r_init,
            {k: jnp.asarray(v) for k, v in param_dict.items()},
            num_uh1=n1, num_uh2=n2, interpret=interpret, stats=True,
            masked=bool(np.isnan(np.asarray(qobs)).any()))

    def fit(self, qobs, prec, etp, s_init=0., r_init=0.,
            loss_metric="mse", seed=None, engine="xla",
            interpret=False, initial_state=None, **de_kwargs):
        """Calibrate the model on observed discharge (device-resident DE).

        Args:
            qobs: Array of observed streamflow discharge.
            prec, etp: forcing arrays.
            s_init, r_init: initial store fillings as fractions, in [0, 1].
            loss_metric: calibration loss -- 'mse' (default),
                'rmse', or 'nse'/'kge' minimizing ``1 - score``
                (both engines; the fused kernel accumulates the
                sufficient statistics on-device for nse/kge).
            seed: (optional) PRNG seed for reproducible evolution.
            engine: 'xla', or 'pallas' to evaluate every DE generation with
                the fused simulate+MSE ensemble kernel
                (:func:`rrmpg_jax.ops.gr4j_ensemble_mse_pallas`).
            initial_state: (optional) single-member
                :class:`~rrmpg_jax.ops.gr4j.GR4JState` -- calibrate a
                continuation segment from a known initial condition
                (operational recalibration on recent data).  Works on
                both engines (the fused kernel enters the carried
                state); mutually exclusive with non-zero
                ``s_init``/``r_init``.
            **de_kwargs: ``method=`` selects the optimizer ('de' default,
                'sce' for SCE-UA); everything else is forwarded to it via
                :func:`rrmpg_jax.tools.calibration.minimize`.

        Returns:
            An :class:`~rrmpg_jax.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize
        from ..utils.metrics import calibration_loss

        loss = calibration_loss(loss_metric)
        qobs = validate_array_input(qobs, np.float64, 'qobs')
        prec, etp = self._validate_forcings(prec, etp)
        s_init, r_init = self._validate_inits(s_init, r_init)
        # NaN observations mark missing-data gaps (e.g. CAMELS -999
        # sentinels): the XLA metrics mask them inherently; the fused
        # kernels get the masked specialization only when gaps exist.
        masked = bool(np.isnan(qobs).any())

        prec_j = jnp.asarray(prec)
        etp_j = jnp.asarray(etp)
        qobs_j = jnp.asarray(qobs)
        bounds = tuple(self._default_bounds[p] for p in self._param_list)

        if initial_state is not None:
            from ..config import default_float
            from .states import single_member_state

            check_state_type(initial_state, GR4JState, type(self).__name__)
            if s_init != 0 or r_init != 0:
                raise ValueError(
                    "Pass either fractional s_init/r_init (cold start) or "
                    "a full initial_state (warm calibration), not both.")
            state = single_member_state(initial_state, default_float())

            if engine == "pallas":
                # Operational refit rides the fused objective kernel:
                # the one shared initial condition broadcasts to every
                # candidate of a DE generation and enters the kernel's
                # state (stores + rebuilt UH registers).
                from ..ops.pallas_gr4j import gr4j_ensemble_mse_pallas
                from ..ops.pallas_snow import losses_from_stats

                x4_hi = self._default_bounds['x4'][1]
                n1, n2 = fit_uh_lengths(x4_hi)
                self._check_history_depth(state.pr_history.shape[-1], n2,
                                          [x4_hi])
                use_stats = loss_metric in ("nse", "kge")

                def batch_objective(X):
                    P = X.shape[0]
                    st = GR4JState(*(jnp.broadcast_to(l, (P,) + l.shape)
                                     for l in state))
                    params = {'x1': X[:, 0], 'x2': X[:, 1],
                              'x3': X[:, 2], 'x4': X[:, 3]}
                    out = gr4j_ensemble_mse_pallas(
                        prec_j, etp_j, qobs_j, 0.0, 0.0, params,
                        num_uh1=n1, num_uh2=n2, interpret=interpret,
                        stats=use_stats, state=st, warm=True,
                        masked=masked)
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
                params = {n: x[i]
                          for i, n in enumerate(self._param_list)}
                qsim, _, _, _ = run_gr4j_warm(prec_j, etp_j, state, params)
                return loss(qobs_j, qsim)

            return minimize(objective, bounds, seed=seed,
                                          **de_kwargs)

        if engine == "pallas":
            from ..ops.pallas_gr4j import gr4j_ensemble_mse_pallas
            from ..ops.pallas_snow import losses_from_stats

            # UH register lengths from the class bounds (x4 <= 2.9 needs
            # only ceil(2.9)=3 / ceil(2*2.9+1)=7 taps).
            n1, n2 = fit_uh_lengths(self._default_bounds['x4'][1])
            use_stats = loss_metric in ("nse", "kge")

            def batch_objective(X):
                params = {'x1': X[:, 0], 'x2': X[:, 1], 'x3': X[:, 2],
                          'x4': X[:, 3]}
                out = gr4j_ensemble_mse_pallas(
                    prec_j, etp_j, qobs_j, s_init, r_init, params,
                    num_uh1=n1, num_uh2=n2, interpret=interpret,
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
            params = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
            qsim, _, _ = run_gr4j(prec_j, etp_j, s_init, r_init, params)
            return loss(qobs_j, qsim)

        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)
