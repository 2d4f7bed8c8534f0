"""GLUE-style uncertainty quantification over Monte-Carlo ensembles.

Generalized Likelihood Uncertainty Estimation (Beven & Binley 1992) on
top of :func:`rrmpg_jax.tools.monte_carlo`: turn per-member goodness-of-
fit into likelihood weights over the behavioral subset, then derive
weighted prediction limits per timestep.  The reference package stops at
percentile bands over the raw ensemble (``rrmpg/utils/plot_utils.py``);
this module adds the likelihood-weighted formulation, fully batched --
the (T, N) quantile computation is one device program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


def glue_weights(scores, behavioral_threshold=0.0, higher_is_better=True):
    """Likelihood weights over the behavioral ensemble subset.

    Args:
        scores: (N,) per-member goodness-of-fit (e.g. NSE or KGE from
            ``monte_carlo(..., metrics=('nse',))``; pass negated losses
            with ``higher_is_better=True`` or raw losses with False).
        behavioral_threshold: members with score below (above, if
            ``higher_is_better=False``) the threshold get zero weight --
            the classic "behavioral" cut (e.g. NSE > 0).
        higher_is_better: direction of the score.

    Returns:
        (N,) numpy array of weights summing to 1 over behavioral members
        (all-zero if no member is behavioral).
    """
    s = jnp.asarray(scores)
    finite = jnp.isfinite(s)
    if higher_is_better:
        behavioral = finite & (s > behavioral_threshold)
        raw = jnp.where(behavioral, s - behavioral_threshold, 0.0)
    else:
        behavioral = finite & (s < behavioral_threshold)
        raw = jnp.where(behavioral, behavioral_threshold - s, 0.0)
    total = jnp.sum(raw)
    w = jnp.where(total > 0, raw / jnp.where(total > 0, total, 1.0), 0.0)
    return np.asarray(w)


@functools.partial(jax.jit, static_argnames=("quantiles",))
def _weighted_quantiles(qsim, weights, quantiles):
    """Weighted per-timestep quantiles of a (T, N) ensemble."""
    order = jnp.argsort(qsim, axis=1)                    # (T, N)
    sorted_q = jnp.take_along_axis(qsim, order, axis=1)
    sorted_w = weights[order]                            # (T, N)
    cdf = jnp.cumsum(sorted_w, axis=1)
    total = cdf[:, -1:]
    cdf = cdf / jnp.where(total > 0, total, 1.0)

    def one_quantile(q):
        # First member whose weighted CDF reaches q.
        idx = jnp.argmax(cdf >= q, axis=1)
        return jnp.take_along_axis(sorted_q, idx[:, None], axis=1)[:, 0]

    return jnp.stack([one_quantile(q) for q in quantiles])


def prediction_limits(qsim, weights, quantiles=(0.05, 0.5, 0.95),
                      batch_size=None):
    """GLUE prediction limits: weighted quantiles of the ensemble.

    Args:
        qsim: (T, N) simulated discharge (``monte_carlo``'s output
            convention: time first, members last).
        weights: (N,) likelihood weights from :func:`glue_weights`.
        quantiles: quantile levels to extract.
        batch_size: (optional) process the time axis in chunks of this
            many steps -- the per-timestep argsort allocates several
            (T, N) temporaries on device, so chunk when the ensemble
            stack approaches HBM (quantiles are independent per
            timestep, results are identical).

    Returns:
        (len(quantiles), T) numpy array of discharge limits.

    Raises:
        ValueError: if every weight is zero (no behavioral member).
    """
    weights = np.asarray(weights)
    if float(np.sum(weights)) <= 0.0:
        raise ValueError(
            "No behavioral ensemble member (all GLUE weights are zero); "
            "relax the behavioral threshold or enlarge the ensemble.")
    quantiles = tuple(float(q) for q in quantiles)
    num_steps = np.shape(qsim)[0]
    if batch_size is None or batch_size >= num_steps:
        q = jnp.asarray(qsim)
        w = jnp.asarray(weights, q.dtype)
        return np.asarray(_weighted_quantiles(q, w, quantiles))
    if not isinstance(batch_size, int) or batch_size < 1:
        raise TypeError(
            f"'batch_size' must be an integer >= 1 or None; got "
            f"{batch_size!r}.")
    parts = []
    for lo in range(0, num_steps, batch_size):
        q = jnp.asarray(qsim[lo:lo + batch_size])
        w = jnp.asarray(weights, q.dtype)
        parts.append(np.asarray(_weighted_quantiles(q, w, quantiles)))
    return np.concatenate(parts, axis=1)
