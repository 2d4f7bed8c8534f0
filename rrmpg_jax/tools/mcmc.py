"""Bayesian parameter inference: device-resident DE-MC sampling.

GLUE (:mod:`rrmpg_jax.tools.uncertainty`) gives informal likelihood
weights; this module adds formal posterior sampling with Differential
Evolution Markov Chain (ter Braak 2006) -- the algorithm family behind
hydrology's DREAM samplers.  DE-MC runs ``C`` parallel chains whose
proposals are scaled differences of two other chains
(``x + gamma * (x_r1 - x_r2) + eps``), which self-tunes the proposal
covariance to the posterior's and makes the chain population exactly
the batch axis this framework is built around: every Metropolis step
evaluates all chains' proposals in one batched device call, and the
whole sampler runs inside a single jitted ``lax.scan``.

Priors are uniform over ``bounds`` (the framework's calibration
convention); out-of-bounds proposals have zero prior density and are
rejected, preserving detailed balance.  Pass any jit-traceable
``log_prob`` -- e.g. a Gaussian log-likelihood built from the MSE
kernels, plus parameter-prior terms if the uniform box is not wanted.
"""

import typing

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..config import default_float
from .calibration import _latin_hypercube


class MCMCResult(typing.NamedTuple):
    """Posterior sample from :func:`demc_sample`.

    Attributes:
        samples: (S, C, dim) retained post-burn-in draws (S kept steps,
            C chains) in real parameter coordinates.
        log_probs: (S, C) their log-posterior values.
        acceptance_rate: mean Metropolis acceptance over all chains and
            retained steps.
        r_hat: (dim,) split-chain Gelman-Rubin statistic of the
            retained draws (values near 1 indicate convergence; rule of
            thumb: require < 1.05).
        x_map: (dim,) the highest-posterior draw seen (incl. burn-in).
        logp_map: its log-posterior.
    """
    samples: np.ndarray
    log_probs: np.ndarray
    acceptance_rate: float
    r_hat: np.ndarray
    x_map: np.ndarray
    logp_map: float

    def flat(self):
        """(S * C, dim) pooled posterior draws."""
        return self.samples.reshape(-1, self.samples.shape[-1])


def _split_r_hat(samples):
    """Split-chain Gelman-Rubin over (S, C, dim) draws."""
    S, C, dim = samples.shape
    half = S // 2
    if half < 2:
        return np.full(dim, np.nan)
    chains = np.concatenate([samples[:half], samples[half:2 * half]],
                            axis=1)                     # (half, 2C, dim)
    n, m = chains.shape[0], chains.shape[1]
    chain_means = chains.mean(axis=0)                   # (2C, dim)
    chain_vars = chains.var(axis=0, ddof=1)             # (2C, dim)
    W = chain_vars.mean(axis=0)
    B = n * chain_means.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B / n
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / W)


def demc_sample(log_prob, bounds, num_chains=None, num_steps=2000,
                burn_in=0.5, thin=1, key=None, seed=None, batched=False,
                gamma=None, jitter=1e-6, mesh=None, mesh_axis=None):
    """Sample a posterior with Differential Evolution MCMC.

    Args:
        log_prob: jit-traceable ``(dim,) -> scalar`` log posterior
            density (up to a constant), vmapped over the chains.  With
            ``batched=True``, maps ``(C, dim) -> (C,)`` in one call --
            use for fused Pallas likelihood kernels.  Non-finite values
            are treated as log(0) (always rejected).
        bounds: sequence of (low, high) pairs; also the uniform prior's
            support -- proposals outside are rejected.
        num_chains: number of parallel chains (default ``max(8, 2 *
            dim)``; ter Braak recommends at least ``2 * dim``).  Chains
            update as two half-ensembles (partners always drawn from
            the frozen complementary half, which keeps the fully
            parallel update a valid MCMC kernel), so odd counts round
            up to even.
        num_steps: Metropolis steps per chain.
        burn_in: fraction of initial steps to discard (0 <= b < 1).
        thin: keep every ``thin``-th post-burn-in step.
        key / seed: PRNG key or int seed.
        batched: see ``log_prob``.
        gamma: proposal scale (default the optimal ``2.38 /
            sqrt(2 dim)``); every 10th step uses ``gamma = 1`` for
            mode-to-mode jumps.
        jitter: scale of the small Gaussian ``eps`` added to proposals
            (breaks the finite-difference lattice).
        mesh: (optional) ``jax.sharding.Mesh``; the chain axis is
            sharded over ``mesh_axis``, so each chip evaluates its
            chains' proposals locally (the cross-chain partner gathers
            compile to collectives).  ``num_chains`` is rounded up to a
            multiple of the axis size.  Requires a vmappable
            (non-``batched``) ``log_prob``.
        mesh_axis: mesh axis name (defaults to the ensemble axis).

    Returns:
        :class:`MCMCResult`.

    Raises:
        ValueError: for an invalid ``burn_in``/``thin`` or too few
            chains (DE-MC needs at least 4 to draw two distinct other
            chains).
    """
    if not 0 <= burn_in < 1:
        raise ValueError(f"'burn_in' must lie in [0, 1); got {burn_in}.")
    if not isinstance(thin, (int, np.integer)) or thin < 1:
        raise ValueError(f"'thin' must be a positive integer; got {thin}.")
    if key is None:
        key = jax.random.PRNGKey(0 if seed is None else seed)

    dtype = default_float()
    lows = jnp.asarray([b[0] for b in bounds], dtype=dtype)
    highs = jnp.asarray([b[1] for b in bounds], dtype=dtype)
    dim = len(bounds)
    C = num_chains if num_chains is not None else max(8, 2 * dim)

    chain_sharding = None
    if mesh is not None:
        if batched:
            raise ValueError(
                "demc_sample(mesh=) shards the chain axis and needs a "
                "per-point (vmappable) log_prob; batched log_probs run "
                "single-device.")
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import ENSEMBLE_AXIS, pad_to_multiple

        if mesh_axis is None:
            mesh_axis = ENSEMBLE_AXIS
        n_shards = mesh.shape[mesh_axis]
        # Two equal half-ensembles AND a shard-count multiple.
        C = pad_to_multiple(C, n_shards if n_shards % 2 == 0
                            else 2 * n_shards)
        chain_sharding = NamedSharding(mesh, P(mesh_axis))

    C = C + (C % 2)  # the red-black block update needs equal halves
    if C < 4:
        raise ValueError(
            f"DE-MC needs >= 4 chains to draw two distinct partners per "
            f"chain; got num_chains={C}.")
    g0 = gamma if gamma is not None else 2.38 / np.sqrt(2.0 * dim)

    batch_log_prob = log_prob if batched else jax.vmap(log_prob)

    def scale(z):
        return lows + z * (highs - lows)

    def safe_eval(z):
        """Log-prob of normalized coords; out-of-bounds/-NaN -> -inf."""
        lp = batch_log_prob(scale(z))
        in_bounds = jnp.all((z >= 0.0) & (z <= 1.0), axis=1)
        lp = jnp.where(jnp.isfinite(lp), lp, -jnp.inf)
        return jnp.where(in_bounds, lp, -jnp.inf)

    H = C // 2

    def half_update(key, block, lp_block, other, t):
        """MH-update every chain of `block` in parallel, proposing with
        two distinct partners drawn from the FROZEN complementary half.

        Updating all chains of one half simultaneously is a valid
        kernel because no block member's proposal references another
        block member; naive all-at-once DE-MC (partners from the same
        moving ensemble) does not leave the product posterior invariant
        -- the pitfall parallel ensemble samplers avoid with exactly
        this red-black split.
        """
        k_r1, k_r2, k_eps, k_u = jax.random.split(key, 4)
        n_other = other.shape[0]
        r1 = jax.random.randint(k_r1, (H,), 0, n_other)
        r2 = jax.random.randint(k_r2, (H,), 0, n_other - 1)
        r2 = jnp.where(r2 >= r1, r2 + 1, r2)       # distinct partners
        g = jnp.where(t % 10 == 9, 1.0, g0).astype(dtype)
        eps = jitter * jax.random.normal(k_eps, (H, dim), dtype=dtype)
        proposal = block + g * (other[r1] - other[r2]) + eps
        lp_new = safe_eval(proposal)
        accept = (jnp.log(jax.random.uniform(k_u, (H,), dtype=dtype))
                  < lp_new - lp_block)
        block = jnp.where(accept[:, None], proposal, block)
        lp_block = jnp.where(accept, lp_new, lp_block)
        return block, lp_block, accept

    def step(carry, t):
        key, z, lp = carry
        key, k_a, k_b = jax.random.split(key, 3)
        za, zb = z[:H], z[H:]
        lpa, lpb = lp[:H], lp[H:]
        za, lpa, acc_a = half_update(k_a, za, lpa, zb, t)
        zb, lpb, acc_b = half_update(k_b, zb, lpb, za, t)
        z = jnp.concatenate([za, zb])
        lp = jnp.concatenate([lpa, lpb])
        accept = jnp.concatenate([acc_a, acc_b])
        if chain_sharding is not None:
            z = lax.with_sharding_constraint(z, chain_sharding)
        return (key, z, lp), (z, lp, accept)

    @jax.jit
    def init(key):
        key, k_init = jax.random.split(key)
        z0 = _latin_hypercube(k_init, C, dim, dtype)
        if chain_sharding is not None:
            z0 = lax.with_sharding_constraint(z0, chain_sharding)
        return key, z0, safe_eval(z0)

    import functools

    @functools.partial(jax.jit, static_argnames="length")
    def run_segment(carry, t0, length):
        return lax.scan(step, carry, t0 + jnp.arange(length))

    # Host-chunked segments: one device program per <=512 steps keeps
    # each launch's sequential-scan execution bounded at a negligible
    # dispatch cost, and at most two program shapes compile.
    seg = min(512, num_steps)
    carry = init(key)
    zs_parts, lps_parts, acc_parts = [], [], []
    done = 0
    while done < num_steps:
        length = min(seg, num_steps - done)
        carry, (zs_c, lps_c, acc_c) = run_segment(
            carry, jnp.asarray(done), length)
        zs_parts.append(np.asarray(zs_c))
        lps_parts.append(np.asarray(lps_c))
        acc_parts.append(np.asarray(acc_c))
        done += length
    zs = np.concatenate(zs_parts)
    lps = np.concatenate(lps_parts)
    accepts = np.concatenate(acc_parts)
    x_all = np.asarray(lows) + zs * (np.asarray(highs) - np.asarray(lows))

    i_map = np.unravel_index(np.argmax(lps), lps.shape)
    x_map = x_all[i_map[0], i_map[1]]
    logp_map = float(lps[i_map])

    keep = slice(int(burn_in * num_steps), None, thin)
    samples = x_all[keep]
    log_probs = lps[keep]
    acceptance = float(accepts[keep].mean())
    return MCMCResult(
        samples=samples, log_probs=log_probs,
        acceptance_rate=acceptance, r_hat=_split_r_hat(samples),
        x_map=x_map, logp_map=logp_map)
