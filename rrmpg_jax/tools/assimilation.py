"""Ensemble data assimilation over simulation state bundles.

The forecast mode (``simulate(initial_state=/return_final_state=)``)
carries self-contained state bundles with a leading ensemble axis --
exactly the object an Ensemble Kalman Filter operates on.  This module
closes the loop for operational forecasting: run the ensemble forward
over an observation window, then pull its states toward the measured
discharge with the stochastic (perturbed-observation) EnKF of Burgers,
van Leeuwen & Evensen (1998).

The update is pure matmul work: with ``N`` members and a flattened state of
``S`` variables, the gain solve is built from the ``(S, d)`` / ``(d, d)``
ensemble covariance matmuls, and the whole analysis step jit-compiles to
a handful of fused contractions -- assimilating a million-member
ensemble costs about as much as simulating it.

Reference framework parity: none (the reference cannot even express a
resumable state -- see ``rrmpg/models/gr4j.py:136-144``); this is a
beyond-reference capability built on the forecast mode.

Domain guard: state bundles also pack *series-derived constants* (the
Cemaneige snow-cover threshold ``g_thresh``, the hysteresis annual solid
precipitation ``psol_annual``).  Those are facts about the forcing
climatology, not dynamical state, and are frozen by default
(:data:`CONSTANT_FIELDS`).
"""

import functools
import typing

import jax
import jax.numpy as jnp
import numpy as np

from ..config import default_float

_dot = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

# State-bundle fields that are series-derived constants, not dynamical
# state: never updated by the filter unless explicitly un-frozen.
CONSTANT_FIELDS = frozenset({"g_thresh", "psol_annual"})

# Default ``postprocess``: repair known bundle types into their physical
# domain (see :func:`rrmpg_jax.models.states.repair_state`); pass
# ``postprocess=None`` explicitly to keep the raw analysis state.
REPAIR_KNOWN = "repair-known-bundles"


def _resolve_postprocess(postprocess, state):
    """Map the :data:`REPAIR_KNOWN` sentinel to :func:`repair_state` for
    known bundle types (no-op for arbitrary pytrees); pass through any
    explicit callable or ``None``."""
    if postprocess is not REPAIR_KNOWN:
        return postprocess
    from ..models.states import is_repairable, repair_state
    try:
        known = is_repairable(state)
    except AttributeError:
        known = False
    return repair_state if known else None


class EnKFDiagnostics(typing.NamedTuple):
    """Per-cycle diagnostics of :func:`assimilation_cycle`.

    Attributes:
        innovation: (C, d) observation minus prior ensemble-mean
            prediction, per cycle.
        prior_spread: (C,) ensemble std of the predicted observation
            before each update.
        posterior_mean: the analysis-mean flattened state after each
            cycle, (C, S).
        param_mean: (C, K) analysis-mean parameters per cycle when
            ``estimate_params=True`` (columns in sorted-name order),
            else None.
        ess: (C,) effective sample size per cycle with ``method='pf'``,
            else None.
    """
    innovation: np.ndarray
    prior_spread: np.ndarray
    posterior_mean: np.ndarray
    param_mean: typing.Optional[np.ndarray] = None  # (C, K), joint mode
    ess: typing.Optional[np.ndarray] = None         # (C,), method='pf'


def _flatten_state(state, frozen):
    """Split a state pytree into update-able and frozen leaves.

    Returns ``(X, rebuild)`` where ``X`` is the (N, S) matrix of all
    non-frozen state variables and ``rebuild(X_new)`` reassembles the
    full pytree (frozen leaves untouched).
    """
    from jax.tree_util import tree_flatten_with_path, tree_unflatten

    paths_leaves, treedef = tree_flatten_with_path(state)
    # Match frozen entries against the leaf's FIELD NAME (the last path
    # component), exactly: substring/whole-path matching would silently
    # over-freeze -- e.g. frozen={'s'} on a GR4J bundle must not also
    # freeze 'pr_history'.
    names = [getattr(path[-1], "name", str(path[-1])) if path else ""
             for path, _ in paths_leaves]
    leaves = [leaf for _, leaf in paths_leaves]

    def leaf_frozen(name):
        return name in frozen

    n = leaves[0].shape[0]
    update_idx = [i for i, nm in enumerate(names) if not leaf_frozen(nm)]
    if not update_idx:
        raise ValueError(
            "Every state field is frozen; nothing for the filter to "
            f"update (frozen={sorted(frozen)}).")
    shapes = [leaves[i].shape[1:] for i in update_idx]
    sizes = [int(np.prod(s, dtype=int)) for s in shapes]
    X = jnp.concatenate(
        [leaves[i].reshape(n, -1) for i in update_idx], axis=1)

    def rebuild(X_new):
        out = list(leaves)
        off = 0
        for i, shape, size in zip(update_idx, shapes, sizes):
            out[i] = X_new[:, off:off + size].reshape((n,) + shape)
            off += size
        return tree_unflatten(treedef, out)

    return X, rebuild


def perturb_state(state, key, rel_std=0.2, abs_std=0.0,
                  frozen=CONSTANT_FIELDS):
    """Mean-preserving multiplicative perturbation of a state ensemble.

    An EnKF needs prior spread: an ensemble whose members share one
    deterministic state (e.g. every member cold-started identically)
    has zero covariance and a zero Kalman gain, so nothing assimilates.
    This spreads the members with lognormal factors
    ``exp(sigma * z - sigma^2 / 2)`` (unit mean, so the ensemble mean
    state is preserved and non-negative stores stay non-negative).

    Multiplicative factors leave *zero-valued* components at exactly
    zero (an all-zero cold-start store would still never assimilate);
    either spin the ensemble up over a short forcing window first so
    the stores are non-zero, or pass ``abs_std`` to add Gaussian floor
    noise to every perturbed component (note: additive noise is not
    sign-safe -- combine with a clipping ``postprocess`` downstream if
    a store must stay non-negative).

    Args:
        state: state pytree with leading ensemble axis ``N``.
        key: jax PRNG key.
        rel_std: relative (multiplicative) perturbation scale ``sigma``.
        abs_std: absolute (additive) Gaussian scale for zero-safe
            spread; 0 disables.
        frozen: exact leaf field names left unperturbed (default: the
            series-derived constants).

    Returns:
        The perturbed state pytree (frozen leaves bit-identical).
    """
    dtype = default_float()
    X, rebuild = _flatten_state(state, frozenset(frozen))
    k_mul, k_add = jax.random.split(key)
    z = jax.random.normal(k_mul, X.shape, dtype=dtype)
    factors = jnp.exp(rel_std * z - 0.5 * rel_std ** 2)
    X = X * factors
    if abs_std:
        X = X + abs_std * jax.random.normal(k_add, X.shape, dtype=dtype)
    return rebuild(X)


def _params_matrix(params, n):
    """Normalize a parameter ensemble (dict or structured array) to a
    name list + (N, K) matrix + a rebuilder into the original kind."""
    if isinstance(params, np.ndarray) and params.dtype.names:
        names = list(params.dtype.names)
        cols = [jnp.asarray(params[nm]) for nm in names]
        out_dtype = params.dtype

        def rebuild(P):
            out = np.empty(n, dtype=out_dtype)
            for j, nm in enumerate(names):
                out[nm] = np.asarray(P[:, j])
            return out
    elif isinstance(params, dict):
        names = sorted(params)
        cols = [jnp.asarray(params[nm]) for nm in names]

        def rebuild(P):
            return {nm: P[:, j] for j, nm in enumerate(names)}
    else:
        raise TypeError(
            "'params' must be a dict of (N,) arrays or a structured "
            f"numpy array; got {type(params).__name__}.")
    for nm, c in zip(names, cols):
        if c.shape != (n,):
            raise ValueError(
                f"params[{nm!r}] has shape {c.shape}; expected ({n},) "
                "to match the state ensemble.")
    return names, jnp.stack(cols, axis=1), rebuild


@jax.jit
def _analysis(X, Y, obs_v, std_v, key, inflation):
    """The jitted EnKF analysis core on the flattened (N, S) ensemble."""
    n = X.shape[0]
    x_mean = X.mean(axis=0)
    y_mean = Y.mean(axis=0)
    # Multiplicative inflation must scale the state AND the predicted-
    # observation anomalies together: inflating only Xa leaves pyy at
    # the uninflated spread, the gain grows linearly with the factor and
    # can exceed 1 (overshooting the observation -> filter divergence).
    # For a linear observation operator this equals inflating the prior
    # and re-predicting.
    Xa = (X - x_mean) * inflation
    Ya = (Y - y_mean) * inflation
    X = x_mean + Xa
    Y = y_mean + Ya
    # Ensemble covariances, at full float32 (a GPU may otherwise run
    # float32 products in TF32).
    pxy = _dot(Xa.T, Ya) / (n - 1)                         # (S, d)
    pyy = _dot(Ya.T, Ya) / (n - 1) + jnp.diag(std_v ** 2)  # (d, d)
    # Perturbed observations: each member assimilates its own draw,
    # which keeps the analysis spread consistent with the Kalman
    # posterior (Burgers et al. 1998).
    eps = std_v * jax.random.normal(key, Y.shape, dtype=X.dtype)
    innov = obs_v[None, :] + eps - Y                  # (N, d)
    # X_a = X + innov @ K^T with K = pxy @ pyy^{-1}; solve on the
    # small (d, d) system instead of forming the inverse.
    kt = jnp.linalg.solve(pyy, pxy.T)                 # (d, S)
    return X + _dot(innov, kt)


def enkf_update(state, predicted, obs, obs_std, key, inflation=1.0,
                frozen=CONSTANT_FIELDS, postprocess=REPAIR_KNOWN,
                params=None, param_bounds=None):
    """One stochastic-EnKF analysis step on an ensemble state bundle.

    Args:
        state: state pytree with leading ensemble axis ``N`` on every
            leaf (e.g. the bundle from ``simulate(...,
            return_final_state=True)`` under an ``N``-member parameter
            batch, or any NamedTuple/pytree of ``(N, ...)`` arrays).
        predicted: (N,) or (N, d) per-member predicted observations
            (e.g. simulated discharge at the observation time).
        obs: scalar or (d,) measured value(s).
        obs_std: scalar or (d,) observation error standard deviation
            (R is diagonal).
        key: jax PRNG key for the observation perturbations.
        inflation: multiplicative prior-spread inflation applied to the
            state anomalies before the update (counters the spread
            collapse of small ensembles; 1.0 = off).
        frozen: iterable of exact leaf field names excluded from the
            update (default: the series-derived constants
            :data:`CONSTANT_FIELDS`).
        postprocess: callable applied to the updated state pytree for
            physical-consistency repairs.  Default
            :data:`REPAIR_KNOWN`: known bundle types are repaired into
            their physical domain (stores clipped non-negative,
            ``sca`` into [0, 1], ``swe_max >= g`` restored -- see
            :func:`rrmpg_jax.models.states.repair_state`), because the
            unconstrained linear-Gaussian analysis can push states out
            of domain and a warm continuation from e.g. a negative
            routing store is NaN.  Pass ``None`` explicitly for the raw
            analysis state, or your own callable.
        params: (optional) parameter ensemble (dict of (N,) arrays or
            structured numpy array) to estimate *jointly* with the
            states (the augmented-state EnKF: parameter columns join
            the flattened state matrix, so discharge observations
            update parameters through their ensemble covariance with
            the prediction).
        param_bounds: (optional) dict of name -> (low, high); updated
            parameters are clipped into their physical bounds.

    Returns:
        The updated state pytree (same structure; frozen leaves
        bit-identical) -- or ``(state, params)`` when ``params`` was
        given, with ``params`` returned in its input kind.

    Raises:
        ValueError: on an ensemble of one (no covariance) or all-frozen
            states.
    """
    dtype = default_float()
    X, rebuild = _flatten_state(state, frozenset(frozen))
    n = X.shape[0]
    n_state = X.shape[1]
    rebuild_params = None
    if params is not None:
        p_names, P, rebuild_params = _params_matrix(params, n)
        X = jnp.concatenate([X, P.astype(dtype)], axis=1)
    if n < 2:
        raise ValueError(
            "The EnKF needs an ensemble (N >= 2 members) to estimate "
            f"covariances; got N={n}. Simulate with a parameter batch "
            "or replicate the state with perturbations first.")

    Y = jnp.asarray(predicted, dtype)
    if Y.ndim == 1:
        Y = Y[:, None]
    obs_v = jnp.atleast_1d(jnp.asarray(obs, dtype))
    std_v = jnp.broadcast_to(jnp.asarray(obs_std, dtype), obs_v.shape)
    d = obs_v.shape[0]
    if Y.shape != (n, d):
        raise ValueError(
            f"'predicted' has shape {tuple(np.shape(predicted))}; "
            f"expected ({n},) or ({n}, {d}) to match the {n}-member "
            f"ensemble and {d} observation(s).")

    postprocess = _resolve_postprocess(postprocess, state)
    X_new = _analysis(X, Y, obs_v, std_v, key,
                      jnp.asarray(inflation, dtype))
    if rebuild_params is not None:
        X_new, P_new = X_new[:, :n_state], X_new[:, n_state:]
        if param_bounds:
            lo = jnp.asarray([param_bounds.get(nm, (-jnp.inf, jnp.inf))[0]
                              for nm in p_names], dtype)
            hi = jnp.asarray([param_bounds.get(nm, (-jnp.inf, jnp.inf))[1]
                              for nm in p_names], dtype)
            P_new = jnp.clip(P_new, lo[None, :], hi[None, :])
        new_params = rebuild_params(P_new)
    new_state = rebuild(X_new)
    if postprocess is not None:
        new_state = postprocess(new_state)
    if rebuild_params is not None:
        return new_state, new_params
    return new_state


class PFInfo(typing.NamedTuple):
    """Diagnostics of one :func:`particle_filter_update` step.

    Attributes:
        ess: effective sample size ``1 / sum(w^2)`` of the posterior
            importance weights (N = perfectly uniform, 1 = degenerate).
        resampled: whether systematic resampling was triggered.
        weights: the (N,) posterior importance weights *before* any
            resampling (prior weights times this step's likelihood,
            normalized).
        next_weights: the (N,) weights to carry into the next analysis
            step -- uniform after a resample, ``weights`` otherwise.
    """
    ess: float
    resampled: bool
    weights: np.ndarray
    next_weights: np.ndarray


@jax.jit
def _pf_weights(Y, obs_v, std_v, w_prior):
    """Posterior importance weights: prior weights times the Gaussian
    observation likelihood, normalized (all in log space)."""
    log_w = (jnp.log(w_prior)
             - 0.5 * jnp.sum(((obs_v[None, :] - Y) / std_v) ** 2,
                             axis=1))
    log_w = log_w - jax.scipy.special.logsumexp(log_w)
    return jnp.exp(log_w)


@jax.jit
def _systematic_resample_indices(weights, key):
    """Systematic resampling: one uniform draw, N stratified positions."""
    n = weights.shape[0]
    u = jax.random.uniform(key, (), dtype=weights.dtype)
    positions = (jnp.arange(n, dtype=weights.dtype) + u) / n
    return jnp.searchsorted(jnp.cumsum(weights), positions)


def particle_filter_update(state, predicted, obs, obs_std, key,
                           params=None, weights=None, ess_threshold=0.5,
                           jitter=0.0, param_jitter=0.0,
                           param_bounds=None, frozen=CONSTANT_FIELDS,
                           postprocess=REPAIR_KNOWN):
    """One bootstrap-particle-filter analysis step on a state ensemble.

    The sequential importance resampling (SIR) alternative to
    :func:`enkf_update`: instead of a linear-Gaussian covariance
    update, members are *weighted* by the Gaussian observation
    likelihood of their predictions and systematically resampled when
    the effective sample size degenerates.  Exact for any nonlinearity
    of the model (no Gaussian-prior assumption), at the price of needing
    larger ensembles in high-dimensional or low-noise settings.

    Weights PERSIST between analysis steps: pass the previous step's
    ``info.next_weights`` back as ``weights`` so individually-weak
    observations accumulate (``w_t ~ w_{t-1} * likelihood_t``) until a
    resample triggers -- without this, every observation that does not
    single-handedly collapse the ESS would be forgotten.

    Args:
        state / predicted / obs / obs_std / key: as in
            :func:`enkf_update`.
        params: (optional) parameter ensemble resampled *with* the
            states.  A particle is the (state, params) pair: whenever
            member parameters differ, pass them here so resampling
            keeps each duplicated state with the parameters that
            produced it.
        weights: (N,) prior importance weights from the previous step's
            ``info.next_weights`` (uniform if omitted -- correct only
            for the first step or right after a resample).
        ess_threshold: resample when ``ESS < ess_threshold * N``
            (0 = never, 1 = always).
        jitter: relative scale of mean-preserving lognormal jitter
            applied to the (non-frozen) state variables after a
            resampling step, to rediversify duplicated particles (the
            regularized PF).
        param_jitter: like ``jitter`` but for ``params`` -- enables
            joint state-parameter filtering (without it the parameter
            sample can only ever thin out).  Clipped into
            ``param_bounds`` when given.
        param_bounds: dict of name -> (low, high) for the post-jitter
            parameter clip.
        frozen / postprocess: as in :func:`enkf_update` (``frozen``
            only affects jitter; resampling correctly permutes every
            member-indexed leaf, constants included).

    Returns:
        ``(state, info)`` -- or ``(state, params, info)`` when
        ``params`` was given -- with :class:`PFInfo` diagnostics.
        Carry ``info.next_weights`` into the next step.
    """
    dtype = default_float()
    postprocess = _resolve_postprocess(postprocess, state)
    n = np.asarray(predicted).shape[0]
    if n < 2:
        raise ValueError(
            "The particle filter needs an ensemble (N >= 2 members); "
            f"got N={n}.")
    Y = jnp.asarray(predicted, dtype)
    if Y.ndim == 1:
        Y = Y[:, None]
    obs_v = jnp.atleast_1d(jnp.asarray(obs, dtype))
    std_v = jnp.broadcast_to(jnp.asarray(obs_std, dtype), obs_v.shape)
    if Y.shape != (n, obs_v.shape[0]):
        raise ValueError(
            f"'predicted' has shape {tuple(np.shape(predicted))}; "
            f"expected ({n},) or ({n}, {obs_v.shape[0]}).")
    if weights is None:
        w_prior = jnp.full(n, 1.0 / n, dtype=dtype)
    else:
        w_prior = jnp.asarray(weights, dtype)
        if w_prior.shape != (n,):
            raise ValueError(
                f"'weights' has shape {w_prior.shape}; expected ({n},).")

    k_res, k_jit = jax.random.split(key)
    w_post = _pf_weights(Y, obs_v, std_v, w_prior)
    ess = float(1.0 / jnp.sum(w_post ** 2))
    resample = ess < ess_threshold * n

    new_params = params
    if resample:
        idx = _systematic_resample_indices(w_post, k_res)
        state = jax.tree.map(lambda leaf: jnp.asarray(leaf)[idx], state)
        if params is not None:
            p_names, P, rebuild_params = _params_matrix(params, n)
            P = P[idx]
            if param_jitter:
                kp, k_jit = jax.random.split(k_jit)
                z = jax.random.normal(kp, P.shape, dtype=dtype)
                P = P * jnp.exp(param_jitter * z
                                - 0.5 * param_jitter ** 2)
                if param_bounds:
                    lo = jnp.asarray(
                        [param_bounds.get(nm, (-jnp.inf, jnp.inf))[0]
                         for nm in p_names], dtype)
                    hi = jnp.asarray(
                        [param_bounds.get(nm, (-jnp.inf, jnp.inf))[1]
                         for nm in p_names], dtype)
                    P = jnp.clip(P, lo[None, :], hi[None, :])
            new_params = rebuild_params(P)
        if jitter:
            state = perturb_state(state, k_jit, rel_std=jitter,
                                  frozen=frozen)
        next_weights = np.full(n, 1.0 / n)
    else:
        next_weights = np.asarray(w_post)
    if postprocess is not None:
        state = postprocess(state)

    info = PFInfo(ess=ess, resampled=bool(resample),
                  weights=np.asarray(w_post), next_weights=next_weights)
    if params is not None:
        return state, new_params, info
    return state, info


def _pf_update_scan(state, y_pred, obs_c, obs_std_j, sub, w_prior, P,
                    ess_threshold, jitter, param_jitter, lo, hi, frozen,
                    postprocess):
    """Traceable (branchless) particle-filter analysis for ``lax.scan``.

    Numerically equivalent to :func:`particle_filter_update` cycle-for-
    cycle under the same keys: the resampling decision becomes a
    ``where``-select over gather indices (identity gather when not
    resampling), and the regularization jitter enters through a
    ``sigma * flag`` scale (``exp(0) = 1`` exactly, so the no-resample
    branch is bit-identical).  Key consumption inside the update never
    feeds the carried key chain, so drawing unconditionally is safe.
    """
    n = y_pred.shape[0]
    dtype = y_pred.dtype
    k_res, k_jit = jax.random.split(sub)
    obs_v = jnp.atleast_1d(obs_c)
    std_v = jnp.broadcast_to(obs_std_j, obs_v.shape)
    w_post = _pf_weights(y_pred[:, None], obs_v, std_v, w_prior)
    ess = 1.0 / jnp.sum(w_post ** 2)
    resample = ess < ess_threshold * n
    flag = jnp.where(resample, jnp.asarray(1.0, dtype),
                     jnp.asarray(0.0, dtype))
    idx = jnp.where(resample, _systematic_resample_indices(w_post, k_res),
                    jnp.arange(n))
    state = jax.tree.map(lambda l: l[idx], state)
    P = P[idx]
    if param_jitter:
        kp, k_jit = jax.random.split(k_jit)
        z = jax.random.normal(kp, P.shape, dtype=dtype)
        sig = param_jitter * flag
        P = P * jnp.exp(sig * z - 0.5 * sig ** 2)
        if lo is not None:
            P = jnp.where(resample, jnp.clip(P, lo[None, :], hi[None, :]),
                          P)
    if jitter:
        state = perturb_state(state, k_jit, rel_std=jitter * flag,
                              frozen=frozen)
    next_w = jnp.where(resample, jnp.full(n, 1.0 / n, dtype=dtype),
                       w_post)
    if postprocess is not None:
        state = postprocess(state)
    return state, P, next_w, ess


def assimilation_cycle(model, forcings, obs, window, obs_std, params=None,
                       initial_state=None, key=None, seed=None,
                       inflation=1.0, frozen=CONSTANT_FIELDS,
                       postprocess=REPAIR_KNOWN, cold_start_kwargs=None,
                       estimate_params=False, param_bounds=None,
                       method="enkf", ess_threshold=0.5, jitter=0.0,
                       backend="host", **sim_kwargs):
    """Sequential forecast/analysis cycling over an observation series.

    Splits the forcing series into consecutive windows; for each window,
    runs the ensemble forward from its current states
    (``simulate(initial_state=..., return_final_state=True)``), then
    assimilates the window-end discharge observation with
    :func:`enkf_update`.

    Args:
        model: any model class instance of this package whose
            ``simulate`` supports forecast mode.
        forcings: dict of full-series forcing arrays, keyed by the
            model's ``simulate`` argument names (e.g. ``{'prec': ...,
            'etp': ...}`` for GR4J).
        obs: (T,) observed discharge aligned with the forcings.
        window: assimilation window length in timesteps (the last
            ``T % window`` steps are left unassimilated).
        obs_std: observation error std (scalar).
        params: parameter ensemble (structured array / dict with N
            members).  Required: the filter needs an ensemble, and a
            model's single instance parameter set yields one member --
            replicate it (``{k: np.full(n, v) ...}``) for pure state
            estimation.
        initial_state: (optional) starting state bundle; cold start if
            omitted.
        key / seed: PRNG key or int seed for observation perturbations.
        inflation / frozen / postprocess: see :func:`enkf_update`.
        cold_start_kwargs: (optional) keyword arguments applied only to
            the first window when no ``initial_state`` is given (e.g.
            ``{'s_init': 0.3}`` -- the store-fraction arguments are
            mutually exclusive with the warm continuations of all later
            windows).
        estimate_params: also update the parameter ensemble each cycle
            (augmented-state EnKF; requires ``params``).  The evolving
            posterior parameters drive all subsequent windows.
        param_bounds: dict of name -> (low, high) clipping for the
            updated parameters (e.g. ``model._default_bounds``);
            strongly recommended with ``estimate_params``.
        method: ``'enkf'`` (default, :func:`enkf_update`) or ``'pf'``
            (:func:`particle_filter_update` -- likelihood weighting +
            systematic resampling with importance weights carried
            across cycles, instead of a covariance update).
        ess_threshold / jitter: particle-filter controls (see
            :func:`particle_filter_update`); ignored for the EnKF
            except that ``jitter`` has no EnKF meaning.  With
            ``method='pf'`` and ``estimate_params=True``, ``jitter``
            is also applied to the parameters after resamples.
        backend: ``'host'`` (default) re-enters ``model.simulate`` per
            window -- flexible (any model, cold starts, both methods)
            but dispatch-bound at scale: every window pays a host
            round-trip plus kernel launch.  ``'scan'`` folds the whole
            forecast/analysis loop into ONE jitted ``lax.scan`` over
            windows (states, parameters, PRNG key and -- for the PF --
            the importance weights as carry; windowed forcing as xs)
            -- the device-resident path for operational cycling (its
            speed against the host loop: ``benchmarks/assim_cycle.py``;
            not measured on a GPU yet).  Both methods run on the
            scan backend (the PF's systematic resampling is
            static-shape and traces as a branchless gather).  The scan
            backend needs an ``initial_state`` (spin up with one
            ``simulate(return_final_state=True)`` call; the cold-start
            irregularity stays on the host path) and a model
            implementing ``_warm_cycle_pieces`` (GR4J, ABC, HBV-Edu
            and the four snow compositions).
        **sim_kwargs: extra keyword arguments for every
            ``model.simulate`` call.

    Returns:
        ``(state, params, qsim, diagnostics)`` where ``state`` is the
        final analysis bundle, ``params`` the final parameter ensemble
        (updated by the EnKF under ``estimate_params=True``, permuted
        with its particles by PF resampling -- members always align
        with ``state``), ``qsim`` the (T_assimilated, N) concatenated
        *prior* (forecast) discharge of every window, and
        ``diagnostics`` an :class:`EnKFDiagnostics`.
    """
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else seed)
    obs = np.asarray(obs)
    lengths = {len(v) for v in forcings.values()}
    if len(lengths) != 1:
        raise ValueError(
            f"Forcing arrays have differing lengths {sorted(lengths)}.")
    (T,) = lengths
    if len(obs) != T:
        raise ValueError(
            f"obs has length {len(obs)} but the forcings have {T}.")
    n_cycles = T // window
    if n_cycles == 0:
        raise ValueError(
            f"window={window} exceeds the series length {T}.")
    if params is None:
        raise ValueError(
            "assimilation_cycle needs a 'params' ensemble (N >= 2 "
            "members): the EnKF estimates covariances across members. "
            "For pure state estimation replicate one parameter set, "
            "e.g. {k: np.full(n, v) for k, v in best.items()}.")

    if method not in ("enkf", "pf"):
        raise ValueError(
            f"Unsupported method {method!r}; choose 'enkf' or 'pf'.")
    if backend not in ("host", "scan"):
        raise ValueError(
            f"Unsupported backend {backend!r}; choose 'host' or 'scan'.")
    if backend == "scan":
        if initial_state is None:
            raise ValueError(
                "backend='scan' needs an 'initial_state' (spin the "
                "ensemble up with one simulate(return_final_state=True) "
                "call); cold starts stay on backend='host'.")
        return _assimilation_cycle_scan(
            model, forcings, obs, window, obs_std, params, initial_state,
            key, n_cycles, inflation=inflation, frozen=frozen,
            postprocess=postprocess, estimate_params=estimate_params,
            param_bounds=param_bounds, method=method,
            ess_threshold=ess_threshold, jitter=jitter,
            sim_kwargs=sim_kwargs)

    state = initial_state
    qsim_parts, innovations, spreads, post_means = [], [], [], []
    param_means, ess_values = [], []
    pf_weights = None
    for c in range(n_cycles):
        sl = slice(c * window, (c + 1) * window)
        cycle_kwargs = {name: arr[sl] for name, arr in forcings.items()}
        cycle_kwargs.update(sim_kwargs)
        cycle_kwargs["params"] = params
        if state is not None:
            cycle_kwargs["initial_state"] = state
        elif cold_start_kwargs:
            cycle_kwargs.update(cold_start_kwargs)
        qsim, state = model.simulate(return_final_state=True,
                                     **cycle_kwargs)
        qsim = np.asarray(qsim)
        qsim_parts.append(qsim)
        y_pred = jnp.asarray(qsim[-1])                 # (N,)
        key, sub = jax.random.split(key)
        if method == "pf" and pf_weights is not None:
            # The PF ensemble is weighted between resamples: its
            # forecast statistics are the weighted ones.
            w = np.asarray(pf_weights)
            y_np = np.asarray(y_pred)
            mean_pred = float(w @ y_np)
            spread = float(np.sqrt(w @ (y_np - mean_pred) ** 2))
        else:
            mean_pred = float(y_pred.mean())
            spread = float(y_pred.std())
        innovations.append(float(obs[sl][-1]) - mean_pred)
        spreads.append(spread)
        if method == "pf":
            # params ALWAYS travel with their particle -- resampling a
            # heterogeneous ensemble must keep each duplicated state
            # with the parameters that produced it.
            state, params, info = particle_filter_update(
                state, y_pred, obs[sl][-1], obs_std, sub,
                params=params, weights=pf_weights,
                ess_threshold=ess_threshold, jitter=jitter,
                param_jitter=jitter if estimate_params else 0.0,
                param_bounds=param_bounds, frozen=frozen,
                postprocess=postprocess)
            pf_weights = info.next_weights
            ess_values.append(info.ess)
        elif estimate_params:
            state, params = enkf_update(
                state, y_pred, obs[sl][-1], obs_std, sub,
                inflation=inflation, frozen=frozen,
                postprocess=postprocess, params=params,
                param_bounds=param_bounds)
        else:
            state = enkf_update(state, y_pred, obs[sl][-1], obs_std,
                                sub, inflation=inflation, frozen=frozen,
                                postprocess=postprocess)
        if estimate_params:
            _, P, _ = _params_matrix(params, np.asarray(y_pred).shape[0])
            param_means.append(np.asarray(P.mean(axis=0)))
        X, _ = _flatten_state(state, frozenset(frozen))
        post_means.append(np.asarray(X.mean(axis=0)))

    diags = EnKFDiagnostics(
        innovation=np.asarray(innovations)[:, None],
        prior_spread=np.asarray(spreads),
        posterior_mean=np.asarray(post_means),
        param_mean=np.asarray(param_means) if estimate_params else None,
        ess=np.asarray(ess_values) if method == "pf" else None)
    qsim_all = np.concatenate(qsim_parts, axis=0)
    return state, params, qsim_all, diags


def _assimilation_cycle_scan(model, forcings, obs, window, obs_std,
                             params, initial_state, key, n_cycles, *,
                             inflation, frozen, postprocess,
                             estimate_params, param_bounds,
                             method="enkf", ess_threshold=0.5,
                             jitter=0.0, sim_kwargs):
    """Device-resident forecast/analysis cycling: ONE ``lax.scan``.

    The host loop (:func:`assimilation_cycle`) re-enters
    ``model.simulate`` per window -- validation, numpy round-trips and a
    fresh device launch every cycle, which is dispatch-bound at
    operational scale (daily cycling over decades).  Here the whole loop
    is one compiled program: the ensemble states, the parameter matrix
    and the PRNG key ride the scan carry; the forcing series (met
    preprocessing done ONCE host-side via the model's
    ``_warm_cycle_pieces``) and the window-end observations are the
    stacked xs.  The per-window analysis reuses the SAME
    :func:`enkf_update` as the host path (``method='enkf'``) or the
    branchless :func:`_pf_update_scan` rendering of
    :func:`particle_filter_update` (``method='pf'``: systematic
    resampling and regularization jitter are static-shape, so they
    trace into the same scan; importance weights ride the carry) -- so
    the two backends are numerically equivalent cycle-for-cycle.
    """
    dtype = default_float()
    frozen = frozenset(frozen)
    postprocess = _resolve_postprocess(postprocess, initial_state)
    if key is None:
        key = jax.random.PRNGKey(0)
    initial_state = jax.tree.map(lambda x: jnp.asarray(x, dtype),
                                 initial_state)
    from ..models.states import is_repairable, repair_state
    if is_repairable(initial_state):
        # Same entry clamping the class warm path applies
        # (models/states.normalize_state).
        initial_state = repair_state(initial_state)

    names, P0, rebuild_params = _params_matrix(
        params, jax.tree.leaves(initial_state)[0].shape[0])
    P0 = P0.astype(dtype)
    pieces = getattr(model, "_warm_cycle_pieces", None)
    if pieces is None:
        raise ValueError(
            f"{type(model).__name__} does not support backend='scan' "
            "(no _warm_cycle_pieces); use backend='host'.")
    time_arrays, warm_step = pieces(forcings, sim_kwargs)

    T_used = n_cycles * window
    windowed = tuple(
        jnp.asarray(a)[:T_used].reshape((n_cycles, window)
                                        + jnp.asarray(a).shape[1:])
        for a in time_arrays)
    obs_end = jnp.asarray(np.asarray(obs, dtype=np.float64)
                          [window - 1:T_used:window], dtype)
    obs_std_j = jnp.asarray(obs_std, dtype)

    n_members = int(jax.tree.leaves(initial_state)[0].shape[0])
    lo = hi = None
    if method == "pf" and estimate_params and param_bounds:
        lo = jnp.asarray([param_bounds.get(nm, (-np.inf, np.inf))[0]
                          for nm in names], dtype)
        hi = jnp.asarray([param_bounds.get(nm, (-np.inf, np.inf))[1]
                          for nm in names], dtype)
    w0 = jnp.full(n_members, 1.0 / n_members, dtype=dtype)

    def body(carry, xs):
        state, P, k, w = carry
        arrays, obs_c = xs[:-1], xs[-1]
        params_dict = {nm: P[:, j] for j, nm in enumerate(names)}
        qsim, new_state = warm_step(arrays, state, params_dict)  # (N, w)
        y_pred = qsim[:, -1]
        k, sub = jax.random.split(k)
        ess = jnp.asarray(0.0, dtype)
        if method == "pf":
            # The PF ensemble is weighted between resamples: its
            # forecast statistics are the weighted ones.
            mean_pred = _dot(w, y_pred)
            spread = jnp.sqrt(_dot(w, (y_pred - mean_pred) ** 2))
            new_state, P_new, w_new, ess = _pf_update_scan(
                new_state, y_pred, obs_c, obs_std_j, sub, w, P,
                ess_threshold, jitter,
                jitter if estimate_params else 0.0, lo, hi, frozen,
                postprocess)
        else:
            mean_pred = jnp.mean(y_pred)
            spread = jnp.std(y_pred)
            w_new = w
            if estimate_params:
                new_state, new_params = enkf_update(
                    new_state, y_pred, obs_c, obs_std_j, sub,
                    inflation=inflation, frozen=frozen,
                    postprocess=postprocess, params=params_dict,
                    param_bounds=param_bounds)
                P_new = jnp.stack([new_params[nm] for nm in names],
                                  axis=1)
            else:
                new_state = enkf_update(
                    new_state, y_pred, obs_c, obs_std_j, sub,
                    inflation=inflation, frozen=frozen,
                    postprocess=postprocess)
                P_new = P
        X, _ = _flatten_state(new_state, frozen)
        ys = (qsim.T, obs_c - mean_pred, spread, jnp.mean(X, axis=0),
              jnp.mean(P_new, axis=0), ess)
        return (new_state, P_new, k, w_new), ys

    @jax.jit
    def run(state, P, k):
        return jax.lax.scan(body, (state, P, k, w0),
                            windowed + (obs_end,))

    (state, P, _, _), (qsim_w, innov, spreads, post_means, p_means,
                       ess_vals) = (
        jax.block_until_ready(run(initial_state, P0, key)))

    diags = EnKFDiagnostics(
        innovation=np.asarray(innov)[:, None],
        prior_spread=np.asarray(spreads),
        posterior_mean=np.asarray(post_means),
        param_mean=np.asarray(p_means) if estimate_params else None,
        ess=np.asarray(ess_vals) if method == "pf" else None)
    qsim_all = np.asarray(qsim_w).reshape(T_used, -1)
    # PF resampling permutes the parameter ensemble even without
    # estimate_params (a particle is the (state, params) pair).
    params_out = (rebuild_params(P)
                  if estimate_params or method == "pf" else params)
    return state, params_out, qsim_all, diags
