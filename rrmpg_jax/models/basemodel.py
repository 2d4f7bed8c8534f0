"""Parent class for all models: parameter registry + batched execution engine.

API-compatible with the reference ``BaseModel``
(``rrmpg/models/basemodel.py:20-175``): structured-dtype parameter arrays,
uniform random sampling within default bounds, dict / ``np.void`` /
structured-ndarray ``set_params``.

What is new: the engine half.  Where every reference model loops
serially over parameter sets calling a numba kernel per set
(e.g. ``rrmpg/models/gr4j.py:169``), models here hand their pure JAX kernel
to :meth:`BaseModel._run_batched`, which jit-compiles ``vmap(kernel)`` over
the parameter axis once per (model, shapes) and evaluates the whole ensemble
as a single device program.  Very large ensembles can additionally shard the
parameter axis over a device mesh (see :mod:`rrmpg_jax.parallel`).
"""

import numbers

import jax
import jax.numpy as jnp
import numpy as np

from ..config import default_float


class BaseModel(object):
    """Base class for all rainfall-runoff models."""

    # List of strings containing all model parameters
    _param_list = []

    # Dict containing the default parameter bounds
    _default_bounds = {}

    # Structured numpy datatype (API parity with the reference; one float64
    # field per parameter).
    _dtype = np.dtype([])

    def __init__(self, params=None):
        """Initialize a hydrological model.

        Args:
            params: (optional) Dictionary with one key/value pair per model
                parameter.  If omitted, random parameters are drawn within
                the default bounds.

        Raises:
            AttributeError: If a model parameter is missing in the passed
                dictionary.
        """
        if params:
            absent = sorted(set(self._param_list) - set(params))
            if absent:
                raise AttributeError(
                    f"Cannot construct {type(self).__name__}: no value given "
                    f"for parameter(s) {absent}.")
        else:
            params = self.get_random_params()

        self.set_params(params)

    # ------------------------------------------------------------------
    # Parameter registry (reference semantics, original implementation)
    # ------------------------------------------------------------------

    def get_random_params(self, num=1):
        """Sample ``num`` random parameter sets uniformly within bounds.

        Returns:
            A structured numpy array of the model's custom dtype.
        """
        lows = np.array([self._default_bounds[p][0] for p in self._param_list])
        highs = np.array([self._default_bounds[p][1] for p in self._param_list])
        draws = np.random.uniform(lows, highs, size=(num, len(self._param_list)))
        params = np.empty(num, dtype=self._dtype)
        for j, p in enumerate(self._param_list):
            params[p] = draws[:, j]
        return params

    def sample_params(self, key, num):
        """Device-side uniform parameter sampling.

        Unlike :meth:`get_random_params` (host numpy RNG, structured array),
        this draws with ``jax.random`` directly into a dict of ``(num,)``
        device arrays -- suitable for sharded multi-million-member ensembles
        without host round-trips, and reproducible from an explicit PRNG key.
        """
        keys = jax.random.split(key, len(self._param_list))
        dtype = default_float()
        out = {}
        for k, param in zip(keys, self._param_list):
            low, high = self._default_bounds[param]
            out[param] = jax.random.uniform(
                k, (num,), dtype=dtype, minval=low, maxval=high)
        return out

    def get_params(self):
        """Return the current parameter values keyed by name."""
        return {param: getattr(self, param) for param in self._param_list}

    def set_params(self, params):
        """Set model parameters from a dict, ``np.void`` or structured array.

        Numpy inputs (a single record or a structured array, in which case
        record 0 is taken) are first converted to a plain dict, then all
        assignments go through one validated path.

        Raises:
            ValueError: If any parameter is not a numerical value.
            AttributeError: If the dict contains an unknown parameter name.
            TypeError: If a numpy array doesn't match the model's custom
                dtype, or the input is neither dict nor numpy array.
        """
        if isinstance(params, (np.void, np.ndarray)):
            if params.dtype != self._dtype:
                raise TypeError(
                    f"Structured parameter input for {type(self).__name__} "
                    f"must have dtype {self._dtype}, got {params.dtype}.")
            record = params if isinstance(params, np.void) else params[0]
            params = {p: record[p] for p in self._param_list}
        elif not isinstance(params, dict):
            raise TypeError(
                "set_params accepts a dict, a numpy record (np.void) or a "
                f"structured numpy array; got {type(params).__name__}.")

        for name, value in params.items():
            if name not in self._param_list:
                raise AttributeError(
                    f"'{name}' is not a parameter of {type(self).__name__}; "
                    f"valid names are {self._param_list}.")
            if not isinstance(value, numbers.Number):
                raise ValueError(
                    f"Parameter '{name}' needs a numeric value, got "
                    f"{type(value).__name__}.")
            setattr(self, name, value)

    def get_parameter_names(self):
        """Return the ordered names of this model's parameters."""
        return self._param_list

    def get_default_bounds(self):
        """Return the per-parameter (lower, upper) default bounds dict."""
        return self._default_bounds

    def get_dtype(self):
        """Return the structured numpy dtype used for parameter arrays."""
        return self._dtype

    # ------------------------------------------------------------------
    # Batched execution engine (replacement of the serial loop)
    # ------------------------------------------------------------------

    def _prepare_params(self, params):
        """Normalize a ``params`` argument to a dict of (N,) arrays.

        Accepts None (use the instance's attributes), ``np.void`` (single
        record), structured ndarray of the model dtype, or a dict of
        scalars/arrays.

        Returns:
            (param_dict, num_sets)
        """
        dtype = default_float()
        if params is None:
            pd = {p: jnp.asarray([getattr(self, p)], dtype=dtype)
                  for p in self._param_list}
            return pd, 1

        if isinstance(params, dict):
            arrs = {p: np.atleast_1d(np.asarray(params[p]))
                    for p in self._param_list}
            num = max(a.shape[0] for a in arrs.values())
            pd = {p: jnp.asarray(np.broadcast_to(a, (num,)), dtype=dtype)
                  for p, a in arrs.items()}
            return pd, num

        if isinstance(params, np.void):
            params = np.expand_dims(params, params.ndim)

        if isinstance(params, np.ndarray):
            if params.dtype != self._dtype:
                raise TypeError(
                    f"Structured parameter input for {type(self).__name__} "
                    f"must have dtype {self._dtype}, got {params.dtype}.")
            pd = {p: jnp.asarray(params[p], dtype=dtype)
                  for p in self._param_list}
            return pd, params.size

        raise TypeError(
            "Unsupported params input: pass None, a dict, a numpy record or "
            f"a structured array of dtype {self._dtype}.")

    @classmethod
    def _batched_kernel(cls, kernel, num_forcing_args, num_mapped_args=1):
        """jit(vmap(kernel)) over the params axis, cached per model class.

        The kernel signature must be ``kernel(*forcings_and_inits,
        *mapped_args)`` where only the trailing ``num_mapped_args`` (the
        params dict, plus a state pytree for warm continuation) are mapped.
        """
        cache = cls.__dict__.get('_kernel_cache')
        if cache is None:
            cache = {}
            setattr(cls, '_kernel_cache', cache)
        cache_key = (kernel, num_forcing_args, num_mapped_args)
        fn = cache.get(cache_key)
        if fn is None:
            in_axes = (None,) * num_forcing_args + (0,) * num_mapped_args
            fn = jax.jit(jax.vmap(kernel, in_axes=in_axes))
            cache[cache_key] = fn
        return fn

    @staticmethod
    def _coerce_forcings(forcing_args):
        """Cast host float arrays to the framework float type (shared by
        the cold and state-carrying execution paths)."""
        dtype = default_float()
        return tuple(
            jnp.asarray(a, dtype=dtype) if isinstance(a, np.ndarray)
            and np.issubdtype(a.dtype, np.floating) else a
            for a in forcing_args)

    @staticmethod
    def _to_reference_layout(series):
        """Move the member axis last (reference output convention,
        e.g. ``rrmpg/models/cemaneige.py:219-245``)."""
        return tuple(np.moveaxis(np.asarray(o), 0, -1) for o in series)

    def _run_batched(self, kernel, forcing_args, params, mesh=None):
        """Evaluate ``kernel`` for every parameter set in one device program.

        Args:
            kernel: pure function ``kernel(*forcing_args, params_dict)``.
            forcing_args: tuple of unbatched (shared) inputs.
            params: dict of (N,) parameter arrays.
            mesh: optional ``jax.sharding.Mesh``; if given, the ensemble
                axis is sharded across its 'ensemble' axis (GSPMD).

        Returns:
            Tuple of outputs with the parameter axis moved *last*
            (reference output convention: ``(T, N)`` / ``(T, L, N)``,
            see e.g. ``rrmpg/models/cemaneige.py:219-245``).
        """
        forcing_args = self._coerce_forcings(forcing_args)
        if mesh is not None:
            from ..parallel.ensemble import ensemble_run
            outputs = ensemble_run(kernel, forcing_args, params, mesh)
        else:
            fn = self._batched_kernel(kernel, len(forcing_args))
            outputs = fn(*forcing_args, params)
        if not isinstance(outputs, tuple):
            outputs = (outputs,)
        return self._to_reference_layout(outputs)

    @staticmethod
    def _check_stateful_supported(engine, mesh):
        """Guard for forecast-mode calls (initial_state/return_final_state)."""
        del mesh  # sharded forecast ensembles are supported
        if engine != "xla":
            raise ValueError(
                "State-carrying simulation (initial_state / "
                "return_final_state) supports engine='xla' only for this "
                "model.")

    @staticmethod
    def _check_stateful_engine(engine, mesh, return_storage):
        """Guard for forecast-mode calls on classes whose fused kernels
        carry state (GR4J and the snow compositions): both engines work,
        but the fused path is discharge-only and single-device."""
        if engine not in ("xla", "pallas"):
            raise ValueError("engine must be 'xla' or 'pallas'.")
        if engine == "pallas":
            if mesh is not None:
                raise ValueError(
                    "engine='pallas' simulate runs single-device through "
                    "the class API and would silently ignore mesh; use "
                    "engine='xla' for sharded forecast ensembles.")
            if return_storage:
                raise ValueError(
                    "engine='pallas' computes discharge only; use "
                    "engine='xla' for storage trajectories.")

    def _run_batched_final(self, kernel, forcing_args, params, state=None,
                           mesh=None):
        """State-carrying variant of :meth:`_run_batched` (forecast mode).

        Args:
            kernel: pure function returning ``(*series, final_state)``;
                signature ``kernel(*forcing_args, params)`` for a cold
                start, ``kernel(*forcing_args, state, params)`` when a
                ``state`` is given (warm continuation).
            forcing_args: tuple of unbatched (shared) inputs.
            params: dict of (N,) parameter arrays.
            state: (optional) state bundle with every leaf batched over
                the leading ensemble axis (use
                :func:`rrmpg_jax.models.states.normalize_state` first).
            mesh: (optional) ``jax.sharding.Mesh``; the ensemble axis of
                the parameters (and state leaves) is sharded across its
                'ensemble' axis -- the sharded-probabilistic-forecast
                path.

        Returns:
            (series, final_state) -- series as numpy arrays with the
            member axis moved *last* (reference output convention),
            ``final_state`` as a state-bundle pytree with the member axis
            *leading* (ready to feed back in as ``state``).
        """
        forcing_args = self._coerce_forcings(forcing_args)
        if mesh is not None:
            from ..parallel.ensemble import ensemble_run
            *series, final = ensemble_run(kernel, forcing_args, params,
                                          mesh, state=state)
        elif state is None:
            fn = self._batched_kernel(kernel, len(forcing_args))
            *series, final = fn(*forcing_args, params)
        else:
            fn = self._batched_kernel(kernel, len(forcing_args),
                                      num_mapped_args=2)
            *series, final = fn(*forcing_args, state, params)
        return self._to_reference_layout(series), final
