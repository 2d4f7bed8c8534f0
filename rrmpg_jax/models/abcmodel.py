"""ABC-model interface class (Fiering 1967; Vogel & Sankarasubramanian 2003).

API-compatible with the reference ``ABCModel``
(``rrmpg/models/abcmodel.py``): same parameters/bounds, constrained random
sampling (b <= 1 - a), simulate/fit signatures and validation behavior.
The ensemble loop of the reference (``abcmodel.py:174``) is replaced by one
batched device program; ``fit`` runs the device-resident differential
evolution instead of scipy's.
"""

import numbers

import jax.numpy as jnp
import numpy as np

from ..ops.abc import run_abcmodel_matscan, run_abcmodel_warm
from ..utils.array_checks import check_for_negatives, validate_array_input
from .basemodel import BaseModel
from .states import ABCState, check_state_type, normalize_state


class ABCModel(BaseModel):
    """Interface to the ABC model."""

    _param_list = ['a', 'b', 'c']

    _default_bounds = {'a': (0, 1),
                       'b': (0, 1),
                       'c': (0, 1)}

    _dtype = np.dtype([('a', np.float64),
                       ('b', np.float64),
                       ('c', np.float64)])

    def __init__(self, params=None):
        super().__init__(params=params)

    def get_random_params(self, num=1):
        """Sample random parameters respecting the constraint b <= 1 - a.

        Mirrors the reference's constrained sampler
        (``rrmpg/models/abcmodel.py:96-101``).
        """
        params = np.zeros(num, dtype=self._dtype)
        params['a'] = np.random.uniform(*self._default_bounds['a'], size=num)
        params['c'] = np.random.uniform(*self._default_bounds['c'], size=num)
        params['b'] = np.random.uniform(self._default_bounds['b'][0],
                                        1 - params['a'], size=num)
        return params

    @staticmethod
    def _kernel(prec, initial_state, params):
        # Toeplitz-matmul linear-scan kernel: fast compile.
        return run_abcmodel_matscan(prec, initial_state, params)

    @staticmethod
    def _warm_kernel(prec, state, params):
        qsim, storage, final = run_abcmodel_warm(prec, state.storage, params)
        return qsim, storage, ABCState(storage=final)

    def simulate(self, prec, initial_state=0, return_storage=False,
                 params=None, mesh=None, engine="xla",
                 return_final_state=False):
        """Simulate streamflow for the passed precipitation.

        Args:
            prec: (T,) precipitation (list, numpy array or pandas.Series).
            initial_state: (optional) initial storage value (scalar, cold
                start with the reference's t=0 init semantics), or an
                :class:`~rrmpg_jax.models.states.ABCState` from a previous
                ``return_final_state=True`` call to continue that
                simulation (forecast mode; every timestep then advances
                the carried storage).
            return_storage: (optional) also return the storage series.
            params: (optional) structured array / dict of parameter sets,
                evaluated batched in one device program.  Defaults to the
                parameters stored in the model instance.
            mesh: (optional) device mesh to shard the ensemble over.
            engine: 'xla' (hierarchical Toeplitz matmul scan), the only
                engine of this model.
            return_final_state: also return the end-of-series
                :class:`~rrmpg_jax.models.states.ABCState` (member axis
                leading), accepted back via ``initial_state=``.

        Returns:
            qsim (T, N) array, plus storage (T, N) if requested, plus the
            final :class:`~rrmpg_jax.models.states.ABCState` if
            ``return_final_state``.

        Raises:
            ValueError: If one of the inputs contains invalid values.
            TypeError: If one of the inputs has an incorrect datatype.
        """
        prec = validate_array_input(prec, np.float64, 'precipitation')
        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")

        warm = not isinstance(initial_state, numbers.Number)
        if warm:
            check_state_type(initial_state, ABCState, type(self).__name__)
        elif initial_state < 0:
            raise TypeError(
                "'initial_state' needs a non-negative numeric scalar (or "
                f"an ABCState for warm continuation); got {initial_state!r}.")
        else:
            initial_state = float(initial_state)

        if not isinstance(return_storage, bool):
            raise TypeError(
                "'return_storage' expects a bool, got "
                f"{type(return_storage).__name__}.")

        param_dict, num = self._prepare_params(params)
        if warm:
            self._check_stateful_supported(engine, mesh)
            from ..config import default_float
            state = normalize_state(initial_state, num, default_float())
            (qsim, storage), final = self._run_batched_final(
                self._warm_kernel, (prec,), param_dict, state=state,
                mesh=mesh)
            out = (qsim,) + ((storage,) if return_storage else ())
            if return_final_state:
                out = out + (final,)
            return out if len(out) > 1 else out[0]
        if engine == "xla":
            qsim, storage = self._run_batched(
                self._kernel, (prec, initial_state), param_dict, mesh=mesh)
        else:
            raise ValueError(
                f"Unsupported engine {engine!r}; the ABC model runs on "
                "engine='xla'.")
        out = (qsim,) + ((storage,) if return_storage else ())
        if return_final_state:
            # The storage series IS the full ABC state; its last row is the
            # per-member final state (cold t=0 init semantics preserved).
            out = out + (ABCState(storage=jnp.asarray(storage[-1])),)
        return out if len(out) > 1 else out[0]

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """Device-resident cycling pieces (see GR4J._warm_cycle_pieces)."""
        import jax

        if sim_kwargs:
            raise ValueError(
                f"ABCModel.simulate takes no extra forcing kwargs; got "
                f"{sorted(sim_kwargs)}.")
        prec = validate_array_input(forcings['prec'], np.float64,
                                    'precipitation')
        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")
        (prec,) = self._coerce_forcings((prec,))
        vk = jax.vmap(self._warm_kernel, in_axes=(None, 0, 0))

        def warm_step(arrays, state, params):
            qsim, _storage, final = vk(arrays[0], state, params)
            return qsim, final

        return (prec,), warm_step

    def fit(self, qobs, prec, initial_state=0, loss_metric="mse",
            seed=None, **de_kwargs):
        """Calibrate the model on observed discharge (device-resident DE).

        Args:
            qobs: Array of observed streamflow discharge.
            prec: Array of precipitation data.
            initial_state: (optional) initial storage value (scalar cold
                start), or a single-member
                :class:`~rrmpg_jax.models.states.ABCState` to calibrate a
                continuation segment from a known initial condition.
            loss_metric: calibration loss -- 'mse' (default),
                'rmse', or 'nse'/'kge' minimizing ``1 - score``.
            seed: (optional) PRNG seed for reproducible evolution.
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
        prec = validate_array_input(prec, np.float64, 'precipitation')
        if check_for_negatives(prec):
            raise ValueError(
                "Precipitation must be non-negative; the input contains "
                "negative values.")

        prec_j = jnp.asarray(prec)
        qobs_j = jnp.asarray(qobs)

        if not isinstance(initial_state, numbers.Number):
            from ..config import default_float
            from .states import single_member_state

            check_state_type(initial_state, ABCState, type(self).__name__)
            state = single_member_state(initial_state, default_float())

            def objective(x):
                params = {'a': x[0], 'b': x[1], 'c': x[2]}
                qsim, _, _ = run_abcmodel_warm(prec_j, state.storage,
                                               params)
                return loss(qobs_j, qsim)
        else:
            if initial_state < 0:
                raise TypeError(
                    "'initial_state' needs a non-negative numeric scalar "
                    f"(or an ABCState); got {initial_state!r}.")
            initial_state = float(initial_state)

            def objective(x):
                params = {'a': x[0], 'b': x[1], 'c': x[2]}
                qsim, _ = run_abcmodel_matscan(prec_j, initial_state,
                                               params)
                return loss(qobs_j, qsim)

        bounds = tuple(self._default_bounds[p] for p in self._param_list)
        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)
