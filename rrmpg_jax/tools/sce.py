"""Shuffled Complex Evolution (SCE-UA) calibration, device-resident.

SCE-UA (Duan, Sorooshian & Gupta 1992) is the classic calibration
algorithm of operational hydrology.  Its textbook form is inherently
serial -- each complex evolves one simplex reflection at a time -- which
is why the reference framework (and most hydrology codebases) never runs
it at scale.  This implementation restructures the algorithm around batched
accelerator execution:

* All ``p`` complexes take their competitive-complex-evolution (CCE)
  step *simultaneously*: the reflection, contraction and mutation
  candidates of every complex are assembled into one ``(3 * p, dim)``
  batch and evaluated in a single device call, then each complex selects
  by the standard priority (reflect if it beats the simplex worst, else
  contract if it does, else mutate unconditionally).  Per shuffle this
  is ``beta`` batched evaluations instead of ``3 * p * beta`` serial
  model runs.
* The full evolve-shuffle loop runs inside one ``lax.while_loop`` under
  ``jit`` -- zero host round-trips until the result is fetched.
* Simplex members are drawn per complex with the trapezoidal rank
  weights of the original algorithm via a Gumbel-top-k draw (vectorized
  sampling without replacement).

Functional differences from the serial textbook algorithm (documented,
quality-neutral): candidates for all three CCE outcomes are always
evaluated (batching makes the extra evaluations free on-device, and
``nfev`` counts them honestly), and an out-of-bounds reflection falls
back to a uniform random point in the *bounds* rather than in the
complex's bounding hypercube.

Non-finite objective values are quarantined exactly like in
:func:`~rrmpg_jax.tools.calibration.differential_evolution`: they are
never selected as best and never shield an incumbent from replacement.
"""

import typing

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import default_float
from .calibration import OptimizeResult, _latin_hypercube


class _SCEState(typing.NamedTuple):
    key: jax.Array
    pop: jax.Array        # (p, m, dim) complex-major, sorted per complex
    energies: jax.Array   # (p, m)
    nit: jax.Array        # shuffles performed


def _safe(e):
    """Energies with non-finite entries pushed to +inf for comparisons."""
    return jnp.where(jnp.isfinite(e), e, jnp.inf)


def _sort_complexes(pop, energies):
    """Sort each complex's members ascending by (quarantined) energy."""
    order = jnp.argsort(_safe(energies), axis=1)
    return (jnp.take_along_axis(pop, order[:, :, None], axis=1),
            jnp.take_along_axis(energies, order, axis=1))


def _shuffle(pop, energies, p, m, dim):
    """Global sort, then deal point ``j`` to complex ``j % p`` (the
    original algorithm's partitioning, so every complex spans the whole
    quality range)."""
    flat_pop = pop.reshape(p * m, dim)
    flat_e = energies.reshape(p * m)
    order = jnp.argsort(_safe(flat_e))
    flat_pop = flat_pop[order]
    flat_e = flat_e[order]
    # Row j of the (m, p) deal is global rank j*p + k for complex k.
    pop = flat_pop.reshape(m, p, dim).transpose(1, 0, 2)
    energies = flat_e.reshape(m, p).T
    return pop, energies


def sce_ua(objective, bounds, key=None, seed=None, n_complexes=None,
           maxiter=100, tol=0.01, atol=0.0, peps=1e-4, batched=False,
           mesh=None, mesh_axis=None):
    """Minimize with Shuffled Complex Evolution (SCE-UA).

    Args:
        objective: jit-traceable ``(dim,) -> scalar`` loss (vmapped over
            candidate batches).  With ``batched=True``, maps a whole
            ``(P, dim)`` batch to ``(P,)`` losses in one call -- use for
            fused Pallas ensemble kernels.
        bounds: sequence of (low, high) pairs, one per dimension.
        key / seed: PRNG key or int seed.
        n_complexes: number of complexes ``p`` (default
            ``max(2, dim)``).  Complex size, simplex size and evolution
            steps per shuffle use Duan's recommendations
            (``m = 2 dim + 1``, ``q = dim + 1``, ``beta = 2 dim + 1``).
        maxiter: maximum number of shuffling iterations.
        tol, atol: convergence tolerance on the population energy spread
            (``std(E) <= atol + tol * |mean(E)|``, the same criterion the
            DE optimizer uses).
        peps: alternative geometric convergence: stop when the
            population's normalized parameter range
            ``exp(mean(log(range_i / bound_range_i)))`` drops below
            ``peps`` (the parameter-space-collapse test of the original
            algorithm).
        mesh: (optional) ``jax.sharding.Mesh``; the complex axis is
            sharded over ``mesh_axis`` so each chip evolves its complexes
            locally between shuffles (the shuffle's global sort compiles
            to cross-chip collectives).  ``n_complexes`` is rounded up to
            a multiple of the axis size.  Requires a vmappable
            (non-``batched``) objective.
        mesh_axis: mesh axis name (defaults to the ensemble axis).

    Returns:
        :class:`~rrmpg_jax.tools.calibration.OptimizeResult` --
        ``population`` / ``population_energies`` hold the final shuffled
        population, ``nit`` the number of shuffles, ``nfev`` every
        objective evaluation (initial sample + ``3 p beta`` per shuffle).
    """
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else seed)

    dtype = default_float()
    lows = jnp.asarray([b[0] for b in bounds], dtype=dtype)
    highs = jnp.asarray([b[1] for b in bounds], dtype=dtype)
    dim = len(bounds)

    p = n_complexes if n_complexes is not None else max(2, dim)
    m = 2 * dim + 1          # points per complex
    q = dim + 1              # simplex size
    beta = 2 * dim + 1       # CCE steps per shuffle

    pop_sharding = None
    if mesh is not None:
        if batched:
            raise ValueError(
                "sce_ua(mesh=) shards the complex axis and needs a "
                "per-point (vmappable) objective; batched objectives "
                "run single-device. Use differential_evolution for "
                "mesh-sharded batched kernels.")
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import ENSEMBLE_AXIS, pad_to_multiple

        if mesh_axis is None:
            mesh_axis = ENSEMBLE_AXIS
        p = pad_to_multiple(p, mesh.shape[mesh_axis])
        pop_sharding = NamedSharding(mesh, P(mesh_axis))
        replicated = NamedSharding(mesh, P())

    if batched:
        batch_objective = objective
    else:
        batch_objective = jax.vmap(objective)

    def scale(z):
        return lows + z * (highs - lows)

    def constrain(pop):
        if pop_sharding is None:
            return pop
        return lax.with_sharding_constraint(pop, pop_sharding)

    # Trapezoidal simplex-selection weights over within-complex ranks
    # (rank 0 = best): w_i = 2 (m - i) / (m (m + 1)).
    rank_logw = jnp.log(2.0 * (m - jnp.arange(m)) / (m * (m + 1.0)))

    def select_simplex(key):
        """Indices of q simplex members for one complex, best-biased
        sampling without replacement (Gumbel-top-k).  Complex rows are
        kept energy-sorted, so sorted indices are energy-ordered."""
        g = jax.random.gumbel(key, (m,), dtype=dtype)
        chosen = jnp.argsort(-(rank_logw + g))[:q]    # top-q ranks
        return jnp.sort(chosen)

    def cce_candidates(key, pop_c):
        """One complex's reflection/contraction/mutation candidates and
        the simplex bookkeeping needed for selection."""
        sel_key, mut_key = jax.random.split(key)
        idx = select_simplex(sel_key)
        simplex = pop_c[idx]                          # (q, dim), sorted
        worst = simplex[-1]
        centroid = jnp.mean(simplex[:-1], axis=0)
        reflect = 2.0 * centroid - worst
        contract = 0.5 * (centroid + worst)
        mutate = jax.random.uniform(mut_key, (dim,), dtype=dtype)
        # An out-of-bounds reflection is disqualified by mutating it.
        oob = jnp.any((reflect < 0.0) | (reflect > 1.0))
        reflect = jnp.where(oob, mutate, reflect)
        return idx, reflect, contract, mutate

    def cce_select(pop_c, energies_c, idx, e_worst, cands, e_cands):
        """Replace the simplex worst by the winning candidate."""
        e_r, e_c, e_m = _safe(e_cands)
        take_r = e_r < _safe(e_worst)
        take_c = ~take_r & (e_c < _safe(e_worst))
        winner = jnp.where(take_r, cands[0],
                           jnp.where(take_c, cands[1], cands[2]))
        e_winner = jnp.where(take_r, e_cands[0],
                             jnp.where(take_c, e_cands[1], e_cands[2]))
        worst_row = idx[-1]
        pop_c = pop_c.at[worst_row].set(winner)
        energies_c = energies_c.at[worst_row].set(e_winner)
        return pop_c, energies_c

    def cce_step(carry, _):
        key, pop, energies = carry
        key, step_key = jax.random.split(key)
        keys = jax.random.split(step_key, p)
        idx, refl, contr, mut = jax.vmap(cce_candidates)(keys, pop)
        e_worst = jnp.take_along_axis(energies, idx[:, -1:], axis=1)[:, 0]
        cands = jnp.stack([refl, contr, mut], axis=1)     # (p, 3, dim)
        e_cands = batch_objective(
            scale(cands.reshape(p * 3, dim))).reshape(p, 3)
        pop, energies = jax.vmap(cce_select)(
            pop, energies, idx, e_worst, cands, e_cands)
        pop, energies = _sort_complexes(constrain(pop), energies)
        return (key, pop, energies), None

    def converged(pop, energies):
        e = energies.reshape(-1)
        finite = jnp.isfinite(e)
        spread_ok = (jnp.std(e) <= atol + tol * jnp.abs(jnp.mean(e)))
        flat = pop.reshape(-1, dim)
        rng = jnp.max(flat, axis=0) - jnp.min(flat, axis=0)
        gnrng = jnp.exp(jnp.mean(jnp.log(jnp.maximum(rng, 1e-30))))
        return (jnp.all(finite) & spread_ok) | (gnrng < peps)

    def init(key):
        key, init_key = jax.random.split(key)
        flat = _latin_hypercube(init_key, p * m, dim, dtype)
        energies = batch_objective(scale(flat))
        pop, energies = _shuffle(flat.reshape(p, m, dim),
                                 energies.reshape(p, m), p, m, dim)
        pop, energies = _sort_complexes(constrain(pop), energies)
        return _SCEState(key, pop, energies, jnp.asarray(0))

    def run(state):
        def cond(state):
            return ((state.nit < maxiter)
                    & ~converged(state.pop, state.energies))

        def body(state):
            (key, pop, energies), _ = lax.scan(
                cce_step, (state.key, state.pop, state.energies), None,
                length=beta)
            pop, energies = _shuffle(pop, energies, p, m, dim)
            pop, energies = _sort_complexes(constrain(pop), energies)
            return _SCEState(key, pop, energies, state.nit + 1)

        return lax.while_loop(cond, body, state)

    if pop_sharding is not None:
        shardings = _SCEState(replicated, pop_sharding, pop_sharding,
                              replicated)
        init = jax.jit(init, out_shardings=shardings)
        run = jax.jit(run, out_shardings=shardings)
    else:
        init = jax.jit(init)
        run = jax.jit(run)

    state = run(init(key))
    _, pop, energies, nit = jax.device_get(state)
    nit = int(nit)
    flat_pop = (np.asarray(lows)
                + pop.reshape(-1, dim) * (np.asarray(highs)
                                          - np.asarray(lows)))
    flat_e = np.asarray(energies).reshape(-1)
    best_idx = int(np.argmin(np.where(np.isfinite(flat_e), flat_e,
                                      np.inf)))
    success = bool(jax.device_get(converged(jnp.asarray(pop),
                                            jnp.asarray(energies))))
    nfev = p * m + nit * beta * 3 * p
    message = ("Optimization terminated successfully." if success else
               "Maximum number of iterations has been exceeded.")
    n_bad = int(np.sum(~np.isfinite(flat_e)))
    if n_bad:
        message += (f" {n_bad}/{p * m} final members have non-finite "
                    "objectives (see population_energies).")
    return OptimizeResult(
        x=flat_pop[best_idx], fun=float(flat_e[best_idx]), nit=nit,
        nfev=nfev, success=success, message=message,
        population=flat_pop, population_energies=flat_e)
