"""Monte-Carlo ensemble simulation.

API-compatible with the reference ``monte_carlo``
(``rrmpg/tools/monte_carlo.py:19-76``), but the ensemble is evaluated as a
single batched device program (the reference loops serially over parameter
sets inside ``model.simulate`` and then computes per-member MSE in a Python
loop; here the MSE reduction is one batched jnp call as well).

For ensembles that exceed a single chip, pass a ``mesh`` -- the parameter
axis is sharded with GSPMD and each chip simulates its shard (see
:mod:`rrmpg_jax.parallel.ensemble`).
"""

import numpy as np

from ..models.basemodel import BaseModel
from ..utils import metrics as _metrics
from ..utils import signatures as _signatures
from ..utils.array_checks import validate_array_input

_METRIC_FNS = {'mse': _metrics.mse, 'rmse': _metrics.rmse,
               'nse': _metrics.nse, 'kge': _metrics.kge,
               'alpha_nse': _metrics.alpha_nse,
               'beta_nse': _metrics.beta_nse, 'r': _metrics.pearson_r,
               # FDC signature diagnostics (same (obs, sim, axis)
               # contract; see rrmpg_jax.utils.signatures).
               'fhv': _signatures.fdc_fhv, 'flv': _signatures.fdc_flv,
               'fms': _signatures.fdc_fms}


# Metrics derivable from the fused kernels' (4,) time-mean sufficient
# statistics [mse, mean_q, mean_q^2, mean_q*qobs]; key -> name in
# ops.pallas_snow.losses_from_stats.
_STATS_METRICS = {'mse': 'mse', 'rmse': 'rmse', 'nse': 'nse',
                  'kge': 'kge', 'alpha_nse': 'alpha',
                  'beta_nse': 'beta', 'r': 'r'}


def monte_carlo(model, num, qobs=None, mesh=None, metrics=('mse',),
                batch_size=None, return_qsim=True, **kwargs):
    """Perform a Monte-Carlo simulation with ``num`` random parameter sets.

    Args:
        model: Any instance of a hydrological model of this package.
        num: Number of simulations.
        qobs: (optional) Array of observed streamflow; if given, the
            requested ``metrics`` of each simulation are returned.
        mesh: (optional) ``jax.sharding.Mesh`` to shard the ensemble over.
        metrics: metric names to evaluate per member when ``qobs`` is
            given; any of 'mse', 'rmse', 'nse', 'kge', 'alpha_nse',
            'beta_nse', 'r' (default ('mse',), the reference's
            contract), plus the FDC signature diagnostics 'fhv',
            'flv', 'fms' (:mod:`rrmpg_jax.utils.signatures`).
        batch_size: (optional) evaluate the ensemble in member chunks of
            this size -- bounds device memory when the full (T, num)
            trajectory stack exceeds HBM (e.g. million-member GLUE runs);
            the assembled result lives in host memory.  At most two
            distinct chunk shapes compile (full chunks + one remainder).
        return_qsim: with ``False`` (requires ``qobs``), trajectories are
            never retained host-side -- the result carries only the
            parameter sets and metrics, so ensemble size is bounded by
            metric storage, not (T, num) trajectories.  When the model
            has a fused sufficient-statistics kernel
            (``engine='pallas'`` and every metric in
            {'mse','rmse','nse','kge','alpha_nse','beta_nse','r'}),
            the whole evaluation runs through it: one device pass,
            four floats per member to HBM, no trajectories anywhere
            (the ``benchmarks/north_star.py`` 10M-member pattern as a
            library call).
        **kwargs: Inputs passed through to ``model.simulate``.

    Returns:
        Dict with keys ``'params'`` (structured array of sampled parameter
        sets), ``'qsim'`` ((T, num) simulated discharge; omitted with
        ``return_qsim=False``) and, if ``qobs`` was passed, one (num,)
        array per requested metric.

    Raises:
        ValueError: If any input contains invalid values.
        TypeError: If any of the inputs has a wrong datatype.
    """
    if not issubclass(model.__class__, BaseModel):
        raise TypeError(
            f"monte_carlo needs an rrmpg_jax model instance (a BaseModel "
            f"subclass); got {type(model).__name__}.")

    if not isinstance(num, int) or num < 1:
        raise TypeError(
            f"The ensemble size 'num' must be an integer >= 1; got {num!r}.")

    if batch_size is not None and (not isinstance(batch_size, int)
                                   or batch_size < 1):
        raise TypeError(
            f"'batch_size' must be an integer >= 1 or None; got "
            f"{batch_size!r}.")

    unknown = [m for m in metrics if m not in _METRIC_FNS]
    if unknown:
        raise ValueError("Unknown metric(s) {}; choose from {}".format(
            unknown, sorted(_METRIC_FNS)))

    if qobs is not None:
        qobs = validate_array_input(qobs, np.float64, 'qobs')
    if not return_qsim and qobs is None:
        raise ValueError(
            "return_qsim=False discards the trajectories, so 'qobs' and "
            "'metrics' are the only output; pass qobs (or keep "
            "return_qsim=True).")

    params = model.get_random_params(num=num)

    if mesh is not None:
        kwargs = dict(kwargs, mesh=mesh)

    # Fused sufficient-statistics path: no trajectories anywhere.
    stats_fn = getattr(model, "_fused_stats", None)
    use_stats = (not return_qsim and stats_fn is not None
                 and kwargs.get("engine") == "pallas"
                 and all(m in _STATS_METRICS for m in metrics))
    if use_stats:
        from ..ops.pallas_snow import losses_from_stats

        def evaluate(param_chunk):
            pd = {n: np.asarray(param_chunk[n])
                  for n in param_chunk.dtype.names}
            stats = stats_fn(qobs, pd, dict(kwargs))
            losses = losses_from_stats(stats, qobs)
            out = {}
            for m in metrics:
                if m == 'beta_nse':
                    # NSE decomposition (mu_sim - mu_obs) / sigma_obs --
                    # NOT the KGE beta ratio that losses_from_stats
                    # computes; derive it from the mean_q stats row.
                    out[m] = ((np.asarray(stats[1]) - qobs.mean())
                              / qobs.std())
                else:
                    out[m] = np.asarray(losses[_STATS_METRICS[m]])
            return None, out
    else:
        def evaluate(param_chunk):
            qsim = model.simulate(params=param_chunk, **kwargs)
            per_metric = {}
            if qobs is not None:
                # Batched jittable reductions over the ensemble axis
                # ((T, N) with obs broadcast; axis 0 is time).
                for name in metrics:
                    per_metric[name] = np.asarray(
                        _METRIC_FNS[name](qobs[:, None], qsim, axis=0))
            return (np.asarray(qsim) if return_qsim else None), per_metric

    if batch_size is None or batch_size >= num:
        qsim, per_metric = evaluate(params)
    else:
        qsim_parts, metric_parts = [], {m: [] for m in metrics}
        for lo in range(0, num, batch_size):
            q, pm = evaluate(params[lo:lo + batch_size])
            if q is not None:
                qsim_parts.append(q)
            for name, vals in pm.items():
                metric_parts[name].append(vals)
        qsim = (np.concatenate(qsim_parts, axis=-1)
                if qsim_parts else None)
        per_metric = {name: np.concatenate(parts)
                      for name, parts in metric_parts.items()}

    result = {'params': params}
    if qsim is not None:
        result['qsim'] = qsim
    if qobs is not None:
        result.update(per_metric)
    return result
