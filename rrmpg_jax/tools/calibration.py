"""Device-resident global optimization for model calibration.

The reference calibrates with ``scipy.optimize.differential_evolution``,
evaluating thousands of model runs one after another in Python
(``rrmpg/models/gr4j.py:247``, nfev ~2.5k-14k).  Here the optimizer itself
is a JAX program: every generation evaluates the whole population as one
``vmap``-batched device call, and the full evolution loop runs inside a
single ``lax.while_loop`` under ``jit`` -- zero host round-trips until the
result is fetched.  On a mesh, the population axis can be sharded so each
generation's simulations spread across chips with an implicit cross-device
argmin (GSPMD inserts the collectives).

The algorithm follows scipy's default configuration: ``best1bin`` strategy,
latin-hypercube initialization, dithered mutation in [0.5, 1), binomial
crossover 0.7, population of ``popsize * dim`` members, and scipy's
convergence criterion ``std(E) <= atol + tol * |mean(E)|``.  Results are
quality-comparable but not bit-identical to scipy (different RNG streams).
"""

import os
import typing

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import default_float


class OptimizeResult(typing.NamedTuple):
    """Result of a calibration run (scipy-compatible field names)."""
    x: np.ndarray          # best parameter vector, shape (dim,)
    fun: float             # best objective value
    nit: int               # number of generations performed
    nfev: int              # number of objective evaluations
    success: bool
    message: str
    population: np.ndarray          # final population, (P, dim)
    population_energies: np.ndarray  # final energies, (P,)

    def nonfinite_members(self):
        """Final-population members whose objective was NaN/inf.

        The optimizer already quarantines them (a non-finite member is
        never selected as best and never shields an incumbent from
        replacement); this surfaces them for debugging -- typically
        HBV's negative-soil power or a degenerate KGE on near-constant
        simulations.

        Returns:
            (members, energies): the offending rows of ``population``
            (real parameter coordinates, shape ``(n_bad, dim)``) and
            their objective values.
        """
        bad = ~np.isfinite(np.asarray(self.population_energies))
        return (np.asarray(self.population)[bad],
                np.asarray(self.population_energies)[bad])


def _latin_hypercube(key, pop_size, dim, dtype):
    """Latin-hypercube sample in [0, 1]^dim."""
    key_perm, key_u = jax.random.split(key)
    perms = jax.vmap(
        lambda k: jax.random.permutation(k, pop_size))(
            jax.random.split(key_perm, dim))          # (dim, P)
    u = jax.random.uniform(key_u, (dim, pop_size), dtype=dtype)
    samples = (perms.astype(dtype) + u) / pop_size
    return samples.T                                   # (P, dim)


def differential_evolution(objective, bounds, key=None, popsize=15,
                           maxiter=1000, tol=0.01, atol=0.0,
                           mutation=(0.5, 1.0), recombination=0.7,
                           seed=None, batched=False, checkpoint_path=None,
                           checkpoint_every=None, resume_from=None,
                           mesh=None, mesh_axis=None, polish=False,
                           polish_steps=200):
    """Global minimization with a fully jitted differential evolution.

    Args:
        objective: function mapping a (dim,) parameter vector to a scalar
            loss.  Must be jit-traceable; it is vmapped over the population.
            With ``batched=True``, the function instead maps the whole
            (P, dim) population to (P,) losses in one call -- use this to
            plug in fused ensemble kernels (e.g.
            :func:`rrmpg_jax.ops.gr4j_ensemble_mse_pallas`).
        bounds: sequence of (low, high) pairs, one per dimension.
        key: jax PRNG key (alternatively pass an int ``seed``).
        popsize: population multiplier; total population = popsize * dim,
            rounded up to a multiple of the mesh's ensemble axis when a
            mesh is given.
        maxiter: maximum number of generations.
        tol, atol: relative/absolute convergence tolerance on the energy
            spread (scipy semantics).
        mutation: (min, max) dithering range for the mutation factor.
        recombination: crossover probability.
        seed: int seed used if ``key`` is None.
        checkpoint_path: (optional) file to write evolution state to every
            ``checkpoint_every`` generations (see
            :mod:`rrmpg_jax.tools.checkpoint`).  A ``*.npz`` path uses the
            single-host atomic-npz backend; any other path is an Orbax
            checkpoint directory (distributed save for multi-host runs).
        checkpoint_every: generations between checkpoints (also the device
            chunk size of the evolution loop).
        resume_from: (optional) checkpoint file to resume evolution from
            (the initial population step is skipped).
        mesh: (optional) ``jax.sharding.Mesh``; the population axis is
            sharded over its ``mesh_axis`` so each chip simulates its
            population shard per generation, with best-member selection and
            convergence reductions compiled to cross-chip collectives.
            With ``batched=True`` the objective is wrapped in a
            ``shard_map`` so fused (Pallas) ensemble kernels run
            chip-locally on their shard.
        mesh_axis: mesh axis name for the population (defaults to the
            framework's ensemble axis).
        polish: run :func:`gradient_descent` from the best member after
            evolution (the analog of scipy's L-BFGS-B polish -- possible
            here because every kernel is differentiable).  The polished
            point is kept only if it improves the objective, so
            ``polish=True`` never worsens the result; objectives that
            cannot be differentiated (e.g. fused Pallas kernels without a
            custom VJP) fall back to the unpolished optimum.
        polish_steps: Adam steps for the polish phase.

    Returns:
        :class:`OptimizeResult`.  ``nfev`` counts ``pop_size * (nit + 1)``
        objective evaluations (every generation evaluates the full
        population -- exact, since selection keeps population size
        constant) plus the polish evaluations when ``polish=True``.
        scipy's reported nfev additionally includes its L-BFGS-B polish
        evaluations, so like-for-like comparisons against scipy should
        use ``polish=True`` here too.
    """
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else seed)

    dtype = default_float()
    lows = jnp.asarray([b[0] for b in bounds], dtype=dtype)
    highs = jnp.asarray([b[1] for b in bounds], dtype=dtype)
    dim = len(bounds)
    pop_size = popsize * dim
    mut_lo, mut_hi = mutation

    pop_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import ENSEMBLE_AXIS, pad_to_multiple

        if mesh_axis is None:
            mesh_axis = ENSEMBLE_AXIS
        n_shards = mesh.shape[mesh_axis]
        pop_size = pad_to_multiple(pop_size, n_shards)
        pop_sharding = NamedSharding(mesh, P(mesh_axis))
        replicated = NamedSharding(mesh, P())
        if batched:
            # Fused ensemble kernels are opaque to GSPMD; run them
            # chip-locally on the population shard instead.  Prefer the
            # STRICT varying-axes checker (it catches objectives that
            # accidentally produce replicated/cross-shard outputs); fall
            # back to the relaxed wrapper only when strict tracing fails,
            # which is the case for Pallas calls (their out_shapes carry
            # no vma annotation).
            from ..parallel.mesh import relaxed_shard_map
            strict = jax.shard_map(objective, mesh=mesh,
                                   in_specs=P(mesh_axis),
                                   out_specs=P(mesh_axis))
            try:
                jax.eval_shape(
                    strict, jax.ShapeDtypeStruct((pop_size, dim), dtype))
                batch_objective = strict
            except (ValueError, NotImplementedError):
                batch_objective = relaxed_shard_map(
                    objective, mesh, in_specs=P(mesh_axis),
                    out_specs=P(mesh_axis))
        else:
            batch_objective = jax.vmap(objective)
    else:
        batch_objective = objective if batched else jax.vmap(objective)

    def scale(norm_pop):
        return lows + norm_pop * (highs - lows)

    def init(key):
        key, init_key = jax.random.split(key)
        pop = _latin_hypercube(init_key, pop_size, dim, dtype)
        if pop_sharding is not None:
            pop = jax.lax.with_sharding_constraint(pop, pop_sharding)
        energies = batch_objective(scale(pop))
        return key, pop, energies, jnp.asarray(0)

    def converged(energies):
        finite = jnp.isfinite(energies)
        mean = jnp.mean(energies)
        std = jnp.std(energies)
        return jnp.all(finite) & (std <= atol + tol * jnp.abs(mean))

    def run_until(state, nit_target):
        def cond(state):
            _, _, energies, nit = state
            return (nit < nit_target) & ~converged(energies)

        def body(state):
            key, pop, energies, nit = state
            (key, f_key, r_key, r2_key, cross_key, fill_key,
             resample_key) = jax.random.split(key, 7)

            # Non-finite energies (NaN from HBV's negative-soil power or
            # a degenerate KGE, +-inf from pathological objectives) must
            # never be selected as 'best' nor shield an incumbent from
            # replacement.
            safe = jnp.where(jnp.isfinite(energies), energies, jnp.inf)
            best = pop[jnp.argmin(safe)]

            # best1bin mutation with dithered F and distinct r1 != r2
            # (both != i), as in scipy's sampler.
            f = jax.random.uniform(f_key, (), dtype=dtype,
                                   minval=mut_lo, maxval=mut_hi)
            own = jnp.arange(pop_size)
            r1 = jax.random.randint(r_key, (pop_size,), 0, pop_size - 1)
            r1 = jnp.where(r1 >= own, r1 + 1, r1)          # exclude self
            r2 = jax.random.randint(r2_key, (pop_size,), 0,
                                    pop_size - 2)
            lo = jnp.minimum(own, r1)
            hi = jnp.maximum(own, r1)
            r2 = jnp.where(r2 >= lo, r2 + 1, r2)
            r2 = jnp.where(r2 >= hi, r2 + 1, r2)           # exclude both
            mutants = best[None, :] + f * (pop[r1] - pop[r2])

            # Binomial crossover with one guaranteed mutant dimension.
            cross = (jax.random.uniform(cross_key, (pop_size, dim),
                                        dtype=dtype) < recombination)
            fill = jax.random.randint(fill_key, (pop_size,), 0, dim)
            cross = cross | (jnp.arange(dim)[None, :] == fill[:, None])
            trials = jnp.where(cross, mutants, pop)

            # Out-of-bounds components are resampled uniformly (scipy's
            # _ensure_constraint behavior).
            resample = jax.random.uniform(resample_key, (pop_size, dim),
                                          dtype=dtype)
            out_of_bounds = (trials < 0.0) | (trials > 1.0)
            trials = jnp.where(out_of_bounds, resample, trials)

            if pop_sharding is not None:
                trials = jax.lax.with_sharding_constraint(trials,
                                                          pop_sharding)
            trial_energies = batch_objective(scale(trials))
            # A finite trial always beats a non-finite incumbent, and a
            # non-finite trial never replaces anything.
            trial_safe = jnp.where(jnp.isfinite(trial_energies),
                                   trial_energies, jnp.inf)
            improved = trial_safe < safe
            pop = jnp.where(improved[:, None], trials, pop)
            energies = jnp.where(improved, trial_energies, energies)
            return key, pop, energies, nit + 1

        return lax.while_loop(cond, body, state)

    if pop_sharding is not None:
        state_shardings = (replicated, pop_sharding, pop_sharding,
                           replicated)
        init = jax.jit(init, out_shardings=state_shardings)
        run_until = jax.jit(run_until, out_shardings=state_shardings)
    else:
        init = jax.jit(init)
        run_until = jax.jit(run_until)

    # Host-level loop in chunks so long calibrations can checkpoint and
    # resume (the reference has no checkpointing at all; restart-from-
    # scratch, see SURVEY.md section 5).  Backend selection: an existing
    # directory (or a new non-.npz path) is an Orbax checkpoint
    # (multi-host: every process writes its shards of a sharded
    # population); an existing regular file or a ``.npz`` path uses the
    # single-host atomic-npz backend -- so checkpoints written by older
    # versions under any name keep resuming correctly.
    def _is_orbax(path):
        if os.path.isdir(path):
            return True
        if os.path.isfile(path):
            return False
        return not str(path).endswith(".npz")

    if checkpoint_path is not None and _is_orbax(checkpoint_path):
        # Fail fast (before hours of evolution) if the optional Orbax
        # dependency is missing.
        import orbax.checkpoint  # noqa: F401

    if resume_from is not None:
        if _is_orbax(resume_from):
            from .checkpoint import load_checkpoint_orbax
            ckpt = load_checkpoint_orbax(resume_from)
        else:
            from .checkpoint import load_checkpoint
            ckpt = load_checkpoint(resume_from)
        state = (jnp.asarray(ckpt['key']), jnp.asarray(ckpt['pop']),
                 jnp.asarray(ckpt['energies']), jnp.asarray(ckpt['nit']))
        if pop_sharding is not None:
            state = (jax.device_put(state[0], replicated),
                     jax.device_put(state[1], pop_sharding),
                     jax.device_put(state[2], pop_sharding),
                     jax.device_put(state[3], replicated))
    else:
        state = init(key)

    chunk = checkpoint_every if checkpoint_every else maxiter
    while True:
        nit = int(state[3])
        if nit >= maxiter or bool(converged(state[2])):
            break
        state = run_until(state, min(nit + chunk, maxiter))
        if checkpoint_path is not None:
            key_, pop_, energies_, nit_ = state
            payload = {'key': key_, 'pop': pop_, 'energies': energies_,
                       'nit': nit_}
            if _is_orbax(checkpoint_path):
                from .checkpoint import save_checkpoint_orbax
                save_checkpoint_orbax(checkpoint_path, payload)
            else:
                from .checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, payload)

    _, pop, energies, nit = jax.device_get(state)
    nit = int(nit)
    pop = np.asarray(lows) + np.asarray(pop) * (np.asarray(highs) -
                                                np.asarray(lows))
    best_idx = int(np.argmin(np.where(np.isfinite(energies), energies,
                                      np.inf)))
    success = bool(jax.device_get(converged(jnp.asarray(energies))))
    x_best = pop[best_idx]
    fun_best = float(energies[best_idx])
    nfev = pop_size * (nit + 1)
    message = ("Optimization terminated successfully." if success else
               "Maximum number of iterations has been exceeded.")
    n_bad = int(np.sum(~np.isfinite(energies)))
    if n_bad:
        # Typically HBV's negative-soil power or a degenerate KGE; such
        # members are never selected, but surface them for debugging.
        message += (f" {n_bad}/{pop_size} final members have non-finite "
                    "objectives (see population_energies).")

    if polish:
        if batched:
            def point_objective(x):
                return objective(x[None, :])[0]
        else:
            point_objective = objective
        try:
            gd = gradient_descent(point_objective, bounds, x0=x_best,
                                  steps=polish_steps)
            nfev += gd.nfev
            if np.isfinite(gd.fun) and gd.fun < fun_best:
                x_best, fun_best = gd.x, float(gd.fun)
                message += " Polished with gradient descent."
        except Exception as exc:  # non-differentiable objective
            message += f" Polish skipped ({type(exc).__name__})."

    return OptimizeResult(
        x=x_best, fun=fun_best, nit=nit,
        nfev=nfev, success=success,
        message=message,
        population=pop,
        population_energies=np.asarray(energies))


def minimize(objective, bounds, method="de", **kwargs):
    """Dispatch to a named global optimizer.

    The model classes' ``fit`` methods route through this, so every
    model accepts ``fit(..., method='sce')`` to calibrate with the
    hydrology-standard SCE-UA instead of the default differential
    evolution.

    Args:
        objective / bounds: as in :func:`differential_evolution`.
        method: ``'de'`` (default, :func:`differential_evolution`) or
            ``'sce'`` (:func:`rrmpg_jax.tools.sce.sce_ua`).
        **kwargs: forwarded to the chosen optimizer.

    Returns:
        :class:`OptimizeResult`.
    """
    if method == "de":
        return differential_evolution(objective, bounds, **kwargs)
    if method == "sce":
        from .sce import sce_ua
        return sce_ua(objective, bounds, **kwargs)
    raise ValueError(
        f"Unsupported calibration method {method!r}; choose 'de' "
        "(differential evolution) or 'sce' (SCE-UA).")


def gradient_descent(objective, bounds, x0=None, steps=500,
                     learning_rate=0.05, key=None, seed=None):
    """Projected gradient descent (Adam) on a differentiable objective.

    Every kernel in this framework is differentiable (where-based
    branchless primitives), which enables calibration the reference's
    numba kernels fundamentally cannot do.  Parameters are optimized in
    normalized [0, 1] coordinates and clipped to the bounds after every
    step; the whole loop runs on-device under one jit.

    Args:
        objective: (dim,) -> scalar loss, differentiable and
            jit-traceable.
        bounds: sequence of (low, high) pairs.
        x0: (optional) starting point in real coordinates; random within
            bounds if omitted.
        steps: number of Adam steps.
        learning_rate: Adam learning rate (in normalized coordinates).
        key / seed: PRNG key or int seed for the random start.

    Returns:
        :class:`OptimizeResult` (population fields hold the single final
        point).
    """
    import optax

    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else seed)
    dtype = default_float()
    lows = jnp.asarray([b[0] for b in bounds], dtype=dtype)
    highs = jnp.asarray([b[1] for b in bounds], dtype=dtype)
    dim = len(bounds)

    if x0 is None:
        z0 = jax.random.uniform(key, (dim,), dtype=dtype)
    else:
        z0 = (jnp.asarray(x0, dtype) - lows) / (highs - lows)

    opt = optax.adam(learning_rate)

    def norm_objective(z):
        return objective(lows + z * (highs - lows))

    @jax.jit
    def run(z0):
        state = opt.init(z0)

        def step(carry, _):
            z, state, best_z, best_val = carry
            val, grads = jax.value_and_grad(norm_objective)(z)
            better = val < best_val
            best_z = jnp.where(better, z, best_z)
            best_val = jnp.where(better, val, best_val)
            # NaN/inf gradients (e.g. outside the physical regime) stall
            # rather than destroy the iterate.
            grads = jnp.where(jnp.isfinite(grads), grads, 0.0)
            updates, state = opt.update(grads, state)
            z = jnp.clip(optax.apply_updates(z, updates), 0.0, 1.0)
            return (z, state, best_z, best_val), val

        init = (z0, state, z0, jnp.asarray(jnp.inf, dtype))
        (z, _, best_z, best_val), _ = lax.scan(step, init, None,
                                               length=steps)
        final_val = norm_objective(z)
        better = final_val < best_val
        best_z = jnp.where(better, z, best_z)
        best_val = jnp.where(better, final_val, best_val)
        return lows + best_z * (highs - lows), best_val

    x, fun = jax.device_get(run(z0))
    success = bool(np.isfinite(fun))
    return OptimizeResult(
        x=np.asarray(x), fun=float(fun), nit=steps, nfev=steps + 1,
        success=success,
        message=("Gradient descent finished." if success else
                 "Objective remained non-finite."),
        population=np.asarray(x)[None, :],
        population_energies=np.asarray([fun]))


def random_search(objective, sample_fn, num, key=None, seed=None,
                  batch_size=None, batched=False, mesh=None,
                  mesh_axis=None):
    """Monte-Carlo minimization: sample ``num`` candidates, keep the best.

    Args:
        objective: (dim,) -> scalar loss, jit-traceable (vmapped here).
            With ``batched=True``, maps the whole (n, dim) candidate batch
            to (n,) losses in one call -- use for fused ensemble kernels.
        sample_fn: ``sample_fn(key, num) -> (num, dim)`` candidate sampler.
        num: number of candidates.
        key / seed: PRNG key or int seed.
        batch_size: optional chunking to bound memory for huge ``num``
            (e.g. 131072-member device chunks for multi-million sweeps).
            With a mesh it is rounded up to a shard-count multiple.
        mesh: (optional) ``jax.sharding.Mesh``; each batch's candidate
            axis is sharded over ``mesh_axis`` (vmapped objectives via
            GSPMD sharding; batched ones via shard_map).
        mesh_axis: mesh axis name (defaults to the ensemble axis).

    Returns:
        :class:`OptimizeResult` (population fields hold the *last* batch).
    """
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else seed)

    cand_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import (ENSEMBLE_AXIS, pad_to_multiple,
                                     relaxed_shard_map)

        if mesh_axis is None:
            mesh_axis = ENSEMBLE_AXIS
        n_shards = mesh.shape[mesh_axis]
        cand_sharding = NamedSharding(mesh, P(mesh_axis))
        if batched:
            batch_objective = jax.jit(relaxed_shard_map(
                objective, mesh, in_specs=P(mesh_axis),
                out_specs=P(mesh_axis)))
        else:
            batch_objective = jax.jit(jax.vmap(objective))
        if batch_size is None:
            batch_size = num
        batch_size = pad_to_multiple(batch_size, n_shards)
    else:
        batch_objective = (jax.jit(objective) if batched
                           else jax.jit(jax.vmap(objective)))
        if batch_size is None:
            batch_size = num

    best_x, best_fun = None, np.inf
    last_pop, last_energies = None, None
    remaining = num
    evaluated = 0
    while remaining > 0:
        n = min(batch_size, remaining)
        if cand_sharding is not None:
            # Shard-count alignment may evaluate a few extra candidates in
            # the final batch; nfev reports the true count.
            from ..parallel.mesh import pad_to_multiple
            n = min(pad_to_multiple(n, mesh.shape[mesh_axis]), batch_size)
        key, sub = jax.random.split(key)
        candidates = sample_fn(sub, n)
        if cand_sharding is not None:
            candidates = jax.device_put(candidates, cand_sharding)
        energies = np.asarray(batch_objective(candidates))
        finite = np.isfinite(energies)
        if finite.any():
            i = int(np.argmin(np.where(finite, energies, np.inf)))
            if energies[i] < best_fun:
                best_fun = float(energies[i])
                best_x = np.asarray(candidates[i])
        last_pop, last_energies = np.asarray(candidates), energies
        remaining -= n
        evaluated += n

    success = best_x is not None
    return OptimizeResult(
        x=best_x, fun=best_fun, nit=1, nfev=evaluated, success=success,
        message=("Random search finished." if success else
                 "Every sampled candidate produced a non-finite loss."),
        population=last_pop, population_energies=last_energies)
