"""Global sensitivity analysis: Sobol' indices and Morris screening.

The reference has no sensitivity-analysis tooling at all; its users fall
back to external packages (SALib) that evaluate the model serially, one
parameter set per call.  Both methods below are embarrassingly parallel
in exactly the way this framework is built for: the whole design matrix
-- ``n * (dim + 2)`` points for Saltelli, ``R * (dim + 1)`` for Morris --
is evaluated as a handful of batched device programs (optionally sharded
over a mesh), so a full variance decomposition of a hydrological model
costs about as much wall-clock as one Monte-Carlo sweep.

Estimators:

* :func:`sobol_indices` -- first-order ``S1`` (Saltelli et al. 2010,
  eq. (b) of Table 2) and total-order ``ST`` (Jansen 1999) indices from a
  Saltelli design built on a scrambled Sobol' quasi-random sequence.
* :func:`morris_screening` -- elementary-effects means ``mu``,
  ``mu_star`` (Campolongo et al. 2007) and standard deviation ``sigma``
  from Morris (1991) one-at-a-time trajectories.

Objectives follow the calibration contract
(:mod:`rrmpg_jax.tools.calibration`): a jit-traceable ``(dim,) -> scalar``
function (vmapped here), or with ``batched=True`` a ``(P, dim) -> (P,)``
function so fused Pallas ensemble kernels plug in directly.
"""

import typing
import warnings

import jax
import numpy as np


class SobolResult(typing.NamedTuple):
    """Variance-based sensitivity indices.

    Attributes:
        s1: (dim,) first-order indices (main effects).
        st: (dim,) total-order indices (main + all interactions).
        s1_conf / st_conf: (dim,) half-widths of the bootstrap 95%
            confidence intervals (zeros when ``bootstrap=0``).
        mean / var: moments of the model output over the design.
        n: base sample size of the Saltelli design.
        n_used: rows that survived the non-finite filter (a row is the
            complete tuple ``f(A_j), f(B_j), f(AB_ij) for all i``).
        nfev: total objective evaluations (``n * (dim + 2)``).
        names: parameter names, if given.
    """
    s1: np.ndarray
    st: np.ndarray
    s1_conf: np.ndarray
    st_conf: np.ndarray
    mean: float
    var: float
    n: int
    n_used: int
    nfev: int
    names: tuple


class MorrisResult(typing.NamedTuple):
    """Elementary-effects screening statistics.

    Attributes:
        mu: (dim,) mean elementary effect (signed; cancellation across
            the input space indicates non-monotonicity).
        mu_star: (dim,) mean absolute elementary effect -- the robust
            importance ranking of Campolongo et al. (2007).
        sigma: (dim,) standard deviation of the effects (interaction /
            nonlinearity indicator).
        mu_star_conf: (dim,) bootstrap 95% half-widths (zeros when
            ``bootstrap=0``).
        n_effects: (dim,) finite elementary effects per parameter.
        nfev: total objective evaluations (``R * (dim + 1)``).
        names: parameter names, if given.

    Elementary effects are taken in *normalized* [0, 1] coordinates, so
    ``mu_star`` is comparable across parameters with different physical
    units (the same convention a unit-hypercube SALib problem uses).
    """
    mu: np.ndarray
    mu_star: np.ndarray
    sigma: np.ndarray
    mu_star_conf: np.ndarray
    n_effects: np.ndarray
    nfev: int
    names: tuple


def _batch_evaluator(objective, batched, mesh, mesh_axis):
    """Build a chunk evaluator ``(m, dim) -> (m,)`` with optional mesh
    sharding, mirroring the calibration tools' objective contract."""
    if mesh is None:
        fn = jax.jit(objective) if batched else jax.jit(jax.vmap(objective))
        return fn, 1

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import ENSEMBLE_AXIS, relaxed_shard_map

    if mesh_axis is None:
        mesh_axis = ENSEMBLE_AXIS
    n_shards = mesh.shape[mesh_axis]
    sharding = NamedSharding(mesh, P(mesh_axis))
    if batched:
        fn = jax.jit(relaxed_shard_map(objective, mesh,
                                       in_specs=P(mesh_axis),
                                       out_specs=P(mesh_axis)))
    else:
        fn = jax.jit(jax.vmap(objective))

    def evaluate(X):
        return fn(jax.device_put(X, sharding))

    return evaluate, n_shards


def _evaluate_design(objective, X, batched, batch_size, mesh, mesh_axis,
                     dtype):
    """Evaluate every row of the (m, dim) design matrix, in chunks.

    Mesh shards require each device call's leading axis to be divisible
    by the shard count; short chunks are padded by repeating the final
    row and the padding results are dropped.
    """
    import jax.numpy as jnp

    m, dim = X.shape
    evaluate, n_shards = _batch_evaluator(objective, batched, mesh,
                                          mesh_axis)
    if batch_size is None:
        batch_size = m
    if n_shards > 1:
        from ..parallel.mesh import pad_to_multiple
        batch_size = pad_to_multiple(batch_size, n_shards)

    out = np.empty(m, dtype=np.float64)
    for lo in range(0, m, batch_size):
        chunk = X[lo:lo + batch_size]
        n = chunk.shape[0]
        if n_shards > 1 and n % n_shards:
            from ..parallel.mesh import pad_to_multiple
            pad = pad_to_multiple(n, n_shards) - n
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        vals = np.asarray(evaluate(jnp.asarray(chunk, dtype)))
        out[lo:lo + n] = vals[:n]
    return out


def _parse_bounds(bounds, names):
    lows = np.asarray([b[0] for b in bounds], dtype=np.float64)
    highs = np.asarray([b[1] for b in bounds], dtype=np.float64)
    dim = len(bounds)
    if names is not None:
        names = tuple(names)
        if len(names) != dim:
            raise ValueError(
                f"Got {len(names)} names for {dim} parameters.")
    return lows, highs, dim, names


def sobol_indices(objective, bounds, n=1024, key=None, seed=None,
                  batched=False, batch_size=None, mesh=None, mesh_axis=None,
                  bootstrap=100, names=None):
    """First- and total-order Sobol' indices via a Saltelli design.

    The design builds two independent quasi-random matrices ``A, B`` of
    ``n`` points each (a scrambled Sobol' sequence in ``2 * dim``
    dimensions, split column-wise) plus the ``dim`` hybrids ``AB_i``
    (``A`` with column ``i`` taken from ``B``), for ``n * (dim + 2)``
    model evaluations total -- all submitted as batched device calls.

    Args:
        objective: jit-traceable ``(dim,) -> scalar`` model output (e.g.
            an MSE/NSE objective, a water-balance term, peak discharge).
            With ``batched=True``, maps ``(P, dim) -> (P,)`` instead --
            use for fused Pallas ensemble kernels.
        bounds: sequence of (low, high) pairs, one per parameter.
        n: base sample size (powers of two keep the Sobol' sequence
            balanced; others work but trigger a scipy warning we
            suppress).
        key / seed: PRNG key or int seed for sequence scrambling.
        batched: see ``objective``.
        batch_size: evaluate the design in chunks of this many rows to
            bound device memory (default: one call for everything).
        mesh: (optional) ``jax.sharding.Mesh``; each chunk's row axis is
            sharded over ``mesh_axis``.
        mesh_axis: mesh axis name (defaults to the ensemble axis).
        bootstrap: number of bootstrap resamples for the confidence
            intervals (0 disables).
        names: (optional) parameter names carried into the result.

    Returns:
        :class:`SobolResult`.  Rows where any of the ``dim + 2``
        evaluations is non-finite (e.g. HBV's negative-soil power) are
        excluded from the estimators; ``n_used`` reports the survivors.

    Raises:
        ValueError: if fewer than 8 complete rows survive the
            non-finite filter, or names/bounds lengths mismatch.
    """
    from ..config import default_float

    lows, highs, dim, names = _parse_bounds(bounds, names)
    if key is not None:
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    rng_seed = 0 if seed is None else seed

    from scipy.stats import qmc
    with warnings.catch_warnings():
        # Unbalanced (non power-of-two) n is the caller's informed choice.
        warnings.simplefilter("ignore", UserWarning)
        sampler = qmc.Sobol(d=2 * dim, scramble=True, seed=rng_seed)
        ab = sampler.random(n)
    A = ab[:, :dim]
    B = ab[:, dim:]

    # Design: [A; B; AB_0; ...; AB_{dim-1}] in normalized coordinates.
    blocks = [A, B]
    for i in range(dim):
        ab_i = A.copy()
        ab_i[:, i] = B[:, i]
        blocks.append(ab_i)
    X = lows + np.concatenate(blocks, axis=0) * (highs - lows)

    f = _evaluate_design(objective, X, batched, batch_size, mesh,
                         mesh_axis, default_float())
    f_A = f[:n]
    f_B = f[n:2 * n]
    f_AB = f[2 * n:].reshape(dim, n)

    keep = (np.isfinite(f_A) & np.isfinite(f_B)
            & np.isfinite(f_AB).all(axis=0))
    n_used = int(keep.sum())
    if n_used < 8:
        raise ValueError(
            f"Only {n_used}/{n} Saltelli rows produced finite outputs "
            "for every design point; the objective is non-finite over "
            "most of the bounded region. Tighten the bounds or guard "
            "the objective.")
    f_A, f_B, f_AB = f_A[keep], f_B[keep], f_AB[:, keep]

    def estimate(f_A, f_B, f_AB):
        # Center the outputs first: the Saltelli S1 estimator is
        # offset-invariant in expectation but its (and the bootstrap's)
        # variance grows with the squared output mean -- uncentered, a
        # log-MSE response with mean ~5 drowns the indices in noise.
        mu = np.mean(np.concatenate([f_A, f_B]))
        f_A, f_B, f_AB = f_A - mu, f_B - mu, f_AB - mu
        var = np.var(np.concatenate([f_A, f_B]))
        if var == 0.0:
            z = np.zeros(dim)
            return z, z
        s1 = np.mean(f_B[None, :] * (f_AB - f_A[None, :]), axis=1) / var
        st = 0.5 * np.mean((f_A[None, :] - f_AB) ** 2, axis=1) / var
        return s1, st

    s1, st = estimate(f_A, f_B, f_AB)

    s1_conf = np.zeros(dim)
    st_conf = np.zeros(dim)
    if bootstrap:
        rng = np.random.default_rng(rng_seed + 1)
        s1_bs = np.empty((bootstrap, dim))
        st_bs = np.empty((bootstrap, dim))
        for b in range(bootstrap):
            idx = rng.integers(0, n_used, n_used)
            s1_bs[b], st_bs[b] = estimate(f_A[idx], f_B[idx], f_AB[:, idx])
        s1_conf = 1.96 * s1_bs.std(axis=0, ddof=1)
        st_conf = 1.96 * st_bs.std(axis=0, ddof=1)

    all_f = np.concatenate([f_A, f_B])
    return SobolResult(
        s1=s1, st=st, s1_conf=s1_conf, st_conf=st_conf,
        mean=float(all_f.mean()), var=float(np.var(all_f)),
        n=n, n_used=n_used, nfev=n * (dim + 2), names=names)


def _morris_trajectories(rng, R, dim, num_levels):
    """Build R Morris trajectories, each (dim + 1, dim), in [0, 1]."""
    delta = num_levels / (2.0 * (num_levels - 1))
    # Base points on the sub-grid {0, 1/(p-1), ...} that keeps x + delta
    # inside [0, 1].
    n_starts = num_levels // 2
    grid = np.arange(n_starts) / (num_levels - 1)

    J = np.ones((dim + 1, dim))
    B = np.tril(np.ones((dim + 1, dim)), k=-1)

    trajs = np.empty((R, dim + 1, dim))
    for r in range(R):
        x_star = rng.choice(grid, size=dim)
        # d_star only controls step ORDER (start high, step down vs start
        # low, step up); every coordinate stays in {x_star, x_star+delta},
        # which the restricted start grid keeps inside [0, 1].
        d_star = rng.choice([-1.0, 1.0], size=dim)
        perm = rng.permutation(dim)
        P = np.eye(dim)[:, perm]
        b_star = (J * x_star
                  + (delta / 2.0) * ((2.0 * B - J) * d_star + J)) @ P
        trajs[r] = b_star
    return trajs, delta


def morris_screening(objective, bounds, num_trajectories=64, num_levels=4,
                     key=None, seed=None, batched=False, batch_size=None,
                     mesh=None, mesh_axis=None, bootstrap=100, names=None):
    """Morris (1991) elementary-effects screening.

    Each trajectory perturbs one parameter at a time by ``delta`` on a
    ``num_levels`` grid, yielding one elementary effect per parameter per
    trajectory at a cost of ``dim + 1`` model runs.  All
    ``num_trajectories * (dim + 1)`` design points are evaluated as
    batched device calls; use this as the cheap screen before a full
    :func:`sobol_indices` study.

    Args:
        objective / batched / batch_size / mesh / mesh_axis / key / seed /
            names: as in :func:`sobol_indices`.
        bounds: sequence of (low, high) pairs, one per parameter.
        num_trajectories: number of one-at-a-time trajectories (R).
        num_levels: grid levels p (even; SALib's default 4 here too).
        bootstrap: resamples (over trajectories) for the ``mu_star``
            confidence interval (0 disables).

    Returns:
        :class:`MorrisResult`.  Non-finite elementary effects (either
        endpoint NaN/inf) are dropped per-parameter; ``n_effects``
        reports how many survived for each.

    Raises:
        ValueError: if ``num_levels`` is odd or < 2, or any parameter
            ends with zero finite elementary effects.
    """
    from ..config import default_float

    if num_levels < 2 or num_levels % 2:
        raise ValueError(
            f"'num_levels' must be an even integer >= 2; got {num_levels}."
            " (Odd grids make the standard delta = p/(2(p-1)) step leave "
            "the unit interval.)")

    lows, highs, dim, names = _parse_bounds(bounds, names)
    if key is not None:
        seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    rng = np.random.default_rng(0 if seed is None else seed)

    R = num_trajectories
    trajs, delta = _morris_trajectories(rng, R, dim, num_levels)
    X = lows + trajs.reshape(R * (dim + 1), dim) * (highs - lows)

    f = _evaluate_design(objective, X, batched, batch_size, mesh,
                         mesh_axis, default_float()
                         ).reshape(R, dim + 1)

    # Consecutive trajectory points differ in exactly one parameter; the
    # signed normalized step recovers which one and in which direction.
    dZ = trajs[:, 1:, :] - trajs[:, :-1, :]          # (R, dim, dim)
    which = np.abs(dZ).argmax(axis=2)                 # (R, dim)
    step = np.take_along_axis(dZ, which[:, :, None], axis=2)[:, :, 0]
    df = f[:, 1:] - f[:, :-1]                         # (R, dim)
    ee_flat = df / step                               # effect of `which`

    # Scatter per-trajectory effects into parameter columns.
    ee = np.full((R, dim), np.nan)
    rows = np.repeat(np.arange(R), dim)
    ee[rows, which.ravel()] = ee_flat.ravel()

    finite = np.isfinite(ee)
    n_effects = finite.sum(axis=0)
    if (n_effects == 0).any():
        bad = [i for i in range(dim) if n_effects[i] == 0]
        label = [names[i] if names else str(i) for i in bad]
        raise ValueError(
            f"No finite elementary effects for parameter(s) {label}; "
            "the objective is non-finite wherever they were perturbed.")

    def masked_stats(ee, finite):
        cnt = finite.sum(axis=0)
        ee0 = np.where(finite, ee, 0.0)
        mu = ee0.sum(axis=0) / cnt
        mu_star = np.abs(np.where(finite, ee, 0.0)).sum(axis=0) / cnt
        var = (np.where(finite, (ee - mu) ** 2, 0.0).sum(axis=0)
               / np.maximum(cnt - 1, 1))
        return mu, mu_star, np.sqrt(var)

    mu, mu_star, sigma = masked_stats(ee, finite)

    mu_star_conf = np.zeros(dim)
    if bootstrap:
        # Resample each parameter's own finite effects: a joint
        # trajectory resample can draw zero finite effects for a
        # parameter (division by zero -> NaN confidence interval) even
        # when the point estimate is fine.
        for i in range(dim):
            e_i = np.abs(ee[finite[:, i], i])
            idx = rng.integers(0, len(e_i), (bootstrap, len(e_i)))
            mu_star_conf[i] = 1.96 * e_i[idx].mean(axis=1).std(ddof=1)

    return MorrisResult(
        mu=mu, mu_star=mu_star, sigma=sigma, mu_star_conf=mu_star_conf,
        n_effects=n_effects, nfev=R * (dim + 1), names=names)
