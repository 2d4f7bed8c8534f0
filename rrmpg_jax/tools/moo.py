"""Multi-objective calibration: device-resident NSGA-II.

The reference's only multi-objective facility is ``fit_Q_SCA``'s fixed
0.75/0.05 scalarization of the discharge and snow-cover errors
(``rrmpg/models/cemaneigehystgr4j.py:663-689``).  A scalarized fit
hides the tradeoff; NSGA-II (Deb et al. 2002) returns the whole Pareto
front instead, and its population structure is a natural fit for this
framework's batched evaluation: every generation evaluates all
offspring in one device call, and the non-dominated sort, crowding
distances and tournament selection are vectorized array programs, so
the full evolve loop runs inside a single jitted ``lax.scan``.

Implementation notes (all shapes static under jit):

* Dominance is the dense ``(2P, 2P)`` boolean matrix
  ``all(f_i <= f_j) & any(f_i < f_j)`` -- O(P^2 M) elementwise work,
  small at calibration sizes.
* Non-dominated *sorting* peels fronts inside a ``while_loop``: each
  iteration marks the members not dominated by any unassigned member,
  assigns them the current rank, and repeats until everyone is ranked.
* Crowding distances are computed per objective with rank-segmented
  sorts (members of different fronts never mix because the sort key
  offsets each front).
* Variation is standard SBX crossover + polynomial mutation in
  normalized [0, 1] coordinates.

Non-finite objective vectors are quarantined: any member with a NaN/inf
component is treated as dominated by every finite member (it can never
enter the returned front while a finite member exists).
"""

import typing

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import default_float
from .calibration import _latin_hypercube

_INF_RANK = 10 ** 9


class ParetoResult(typing.NamedTuple):
    """Result of a multi-objective optimization.

    Attributes:
        x: (F, dim) parameter vectors of the final non-dominated front.
        f: (F, M) their objective vectors.
        population: (P, dim) the full final population.
        population_f: (P, M) its objective vectors.
        rank: (P,) non-domination rank of each member (0 = front).
        nit: generations performed.
        nfev: objective evaluations.
    """
    x: np.ndarray
    f: np.ndarray
    population: np.ndarray
    population_f: np.ndarray
    rank: np.ndarray
    nit: int
    nfev: int


def _dominance(F):
    """(P, P) matrix: [i, j] = member i dominates member j.

    A member with any non-finite objective never dominates and is
    dominated by every finite member.
    """
    finite = jnp.all(jnp.isfinite(F), axis=1)
    Fs = jnp.where(finite[:, None], F, jnp.inf)
    le = jnp.all(Fs[:, None, :] <= Fs[None, :, :], axis=2)
    lt = jnp.any(Fs[:, None, :] < Fs[None, :, :], axis=2)
    dom = le & lt
    # Break inf-vs-inf ties: non-finite members never dominate.
    return dom & finite[:, None]


def _nondominated_ranks(F):
    """(P,) dominance-depth ranks by iterative front peeling."""
    dom = _dominance(F)                      # dom[i, j]: i dominates j
    P = F.shape[0]
    ranks = jnp.full(P, _INF_RANK)

    def cond(carry):
        ranks, k = carry
        return jnp.any(ranks == _INF_RANK) & (k < P)

    def body(carry):
        ranks, k = carry
        unassigned = ranks == _INF_RANK
        # Dominated by any *unassigned* member => not in this front.
        dominated = jnp.any(dom & unassigned[:, None], axis=0)
        in_front = unassigned & ~dominated
        # Safety: if numerical weirdness yields an empty front, assign
        # all remaining members to rank k to guarantee progress.
        in_front = jnp.where(jnp.any(in_front), in_front, unassigned)
        ranks = jnp.where(in_front, k, ranks)
        return ranks, k + 1

    ranks, _ = lax.while_loop(cond, body, (ranks, jnp.asarray(0)))
    return ranks


def nsga2(objectives, bounds, pop_size=128, n_generations=100, key=None,
          seed=None, batched=False, crossover_prob=0.9, crossover_eta=15.0,
          mutation_eta=20.0, mutation_prob=None):
    """Multi-objective minimization with a fully jitted NSGA-II.

    Args:
        objectives: jit-traceable ``(dim,) -> (M,)`` vector of losses to
            minimize jointly (vmapped over the population).  With
            ``batched=True``, maps ``(P, dim) -> (P, M)`` in one call --
            stack fused Pallas objectives columnwise.
        bounds: sequence of (low, high) pairs, one per dimension.
        pop_size: population size (rounded up to an even number).
        n_generations: number of generations.
        key / seed: PRNG key or int seed.
        crossover_prob / crossover_eta: SBX crossover probability and
            distribution index.
        mutation_eta: polynomial-mutation distribution index.
        mutation_prob: per-gene mutation probability (default
            ``1 / dim``).

    Returns:
        :class:`ParetoResult` -- ``x`` / ``f`` hold the final
        non-dominated set (rank 0, deduplicated members included as
        evolved).
    """
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else seed)
    dtype = default_float()
    lows = jnp.asarray([b[0] for b in bounds], dtype=dtype)
    highs = jnp.asarray([b[1] for b in bounds], dtype=dtype)
    dim = len(bounds)
    P = pop_size + (pop_size % 2)
    p_mut = (1.0 / dim) if mutation_prob is None else mutation_prob

    batch_objectives = objectives if batched else jax.vmap(objectives)

    def scale(z):
        return lows + z * (highs - lows)

    def crowding(F, ranks):
        """Crowding distance, vectorized with rank-segmented sorts.

        Each objective's gap is normalized by that objective's range
        WITHIN the member's front (Deb's f_max - f_min term): without
        it, truncation and tournaments are dominated by whichever
        objective has the larger physical scale (e.g. the summed SCA
        loss vs 1-KGE in fit_Q_SCA, a ~10x gap).
        """
        n, M = F.shape
        Fs = jnp.where(jnp.isfinite(F), F, jnp.inf)
        big = jnp.asarray(jnp.inf, dtype)
        total = jnp.zeros(n, dtype=dtype)
        for m in range(M):
            col = Fs[:, m]
            f_lo = jax.ops.segment_min(col, ranks, num_segments=n)
            f_hi = jax.ops.segment_max(col, ranks, num_segments=n)
            span = (f_hi - f_lo)[ranks]              # per member
            order = jnp.lexsort((col, ranks))
            r_s = ranks[order]
            f_s = col[order]
            span_s = span[order]
            prev_same = jnp.concatenate(
                [jnp.array([False]), r_s[1:] == r_s[:-1]])
            next_same = jnp.concatenate(
                [r_s[:-1] == r_s[1:], jnp.array([False])])
            f_prev = jnp.concatenate([f_s[:1], f_s[:-1]])
            f_next = jnp.concatenate([f_s[1:], f_s[-1:]])
            interior = prev_same & next_same
            # Degenerate spans (identical or non-finite objective over
            # the whole front) contribute nothing for interior members.
            ok = jnp.isfinite(span_s) & (span_s > 0.0)
            d_sorted = jnp.where(
                interior,
                jnp.where(ok, (f_next - f_prev) / jnp.where(ok, span_s,
                                                            1.0), 0.0),
                big)
            d_sorted = jnp.where(jnp.isnan(d_sorted), big, d_sorted)
            contrib = jnp.zeros(n, dtype=dtype).at[order].set(d_sorted)
            total = total + contrib  # inf + x = inf: boundaries stay inf
        return total

    def tournament(key, ranks, crowd):
        """P binary tournaments on (rank asc, crowding desc)."""
        i = jax.random.randint(key, (2, P), 0, P)
        a, b = i[0], i[1]
        a_wins = ((ranks[a] < ranks[b])
                  | ((ranks[a] == ranks[b]) & (crowd[a] > crowd[b])))
        return jnp.where(a_wins, a, b)

    def sbx(key, parents):
        """Simulated binary crossover on (P, dim) normalized parents."""
        k_u, k_do, k_gene = jax.random.split(key, 3)
        p1 = parents[: P // 2]
        p2 = parents[P // 2:]
        u = jax.random.uniform(k_u, p1.shape, dtype=dtype)
        beta = jnp.where(
            u <= 0.5,
            (2.0 * u) ** (1.0 / (crossover_eta + 1.0)),
            (1.0 / (2.0 * (1.0 - u))) ** (1.0 / (crossover_eta + 1.0)))
        c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
        c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
        # Apply per pair with crossover_prob, per gene with 0.5.
        do = (jax.random.uniform(k_do, (P // 2, 1), dtype=dtype)
              < crossover_prob)
        gene = jax.random.uniform(k_gene, p1.shape, dtype=dtype) < 0.5
        mask = do & gene
        c1 = jnp.where(mask, c1, p1)
        c2 = jnp.where(mask, c2, p2)
        return jnp.clip(jnp.concatenate([c1, c2]), 0.0, 1.0)

    def poly_mutation(key, pop):
        k_u, k_do = jax.random.split(key)
        u = jax.random.uniform(k_u, pop.shape, dtype=dtype)
        lo_side = u < 0.5
        delta = jnp.where(
            lo_side,
            (2.0 * u) ** (1.0 / (mutation_eta + 1.0)) - 1.0,
            1.0 - (2.0 * (1.0 - u)) ** (1.0 / (mutation_eta + 1.0)))
        do = jax.random.uniform(k_do, pop.shape, dtype=dtype) < p_mut
        return jnp.clip(pop + jnp.where(do, delta, 0.0), 0.0, 1.0)

    def generation(carry, _):
        key, pop, F = carry
        key, k_t, k_x, k_m = jax.random.split(key, 4)
        ranks = _nondominated_ranks(F)
        crowd = crowding(F, ranks)
        parents = pop[tournament(k_t, ranks, crowd)]
        children = poly_mutation(k_m, sbx(k_x, parents))
        F_child = batch_objectives(scale(children))
        # Environmental selection on the combined 2P pool.
        pop2 = jnp.concatenate([pop, children])
        F2 = jnp.concatenate([F, F_child])
        ranks2 = _nondominated_ranks(F2)
        crowd2 = crowding(F2, ranks2)
        # argsort by (rank asc, crowding desc); inf crowding first.
        keep = jnp.lexsort((-crowd2, ranks2))[:P]
        return (key, pop2[keep], F2[keep]), None

    @jax.jit
    def run(key):
        key, k_init = jax.random.split(key)
        pop = _latin_hypercube(k_init, P, dim, dtype)
        F = batch_objectives(scale(pop))
        (key, pop, F), _ = lax.scan(generation, (key, pop, F), None,
                                    length=n_generations)
        ranks = _nondominated_ranks(F)
        return pop, F, ranks

    pop, F, ranks = jax.device_get(run(key))
    pop = np.asarray(lows) + pop * (np.asarray(highs) - np.asarray(lows))
    front = ranks == 0
    return ParetoResult(
        x=pop[front], f=F[front], population=pop, population_f=F,
        rank=ranks, nit=n_generations,
        nfev=P * (n_generations + 1))


def hypervolume_2d(f, ref):
    """Exact dominated hypervolume of a bi-objective minimization front.

    The standard scalar quality indicator for comparing fronts (larger
    is better): the area dominated by the points and bounded by the
    reference point.  Points not strictly better than ``ref`` in both
    objectives contribute nothing; dominated/duplicate points are
    handled naturally by the sweep.

    Args:
        f: (P, 2) objective vectors (minimization).
        ref: (2,) reference point, worse than every interesting point
            (e.g. the nadir of the initial population).

    Returns:
        float dominated area.
    """
    f = np.asarray(f, dtype=float)
    ref = np.asarray(ref, dtype=float)
    if f.ndim != 2 or f.shape[1] != 2:
        raise ValueError(
            f"hypervolume_2d needs (P, 2) objectives; got {f.shape}.")
    keep = np.isfinite(f).all(axis=1) & (f < ref).all(axis=1)
    pts = f[keep]
    if pts.shape[0] == 0:
        return 0.0
    pts = pts[np.argsort(pts[:, 0])]
    hv = 0.0
    prev_y = ref[1]
    for x, y in pts:
        if y < prev_y:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return float(hv)
