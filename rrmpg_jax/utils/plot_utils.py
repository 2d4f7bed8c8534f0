"""Plotting helpers for ensemble simulations.

Functional equivalent of the reference ``plot_qsim_range``
(``rrmpg/utils/plot_utils.py:22-91``): plots the (5, 95) and (25, 75)
percentile bands over an ensemble of simulations plus the ensemble mean
and optionally the observations.  For very large sharded ensembles,
reduce to the four (T,) percentile bands on device first
(``jnp.percentile`` over the member axis) and pass the result here.
"""

import numpy as np


def plot_qsim_range(qsim, x_vals=None, qobs=None):
    """Plot the range of multiple simulations and their mean.

    Args:
        qsim: 2D array of simulations, shape (num_timesteps, num_sims).
        x_vals: (optional) 1D array used as x-axis values (e.g. dates).
        qobs: (optional) 1D array of observations.

    Returns:
        ``(fig, ax)`` matplotlib handles.

    Raises:
        ValueError: For incorrect inputs.
    """
    import matplotlib.pyplot as plt
    import pandas as pd

    qsim = np.asarray(qsim)
    if qsim.ndim != 2:
        raise ValueError(
            f"Expected a (timesteps, members) 2-D ensemble for 'qsim'; got "
            f"an array with ndim={qsim.ndim}.")

    if x_vals is not None:
        if not isinstance(x_vals, (list, np.ndarray, pd.Series, pd.Index)):
            raise ValueError(
                f"Unsupported x-axis container {type(x_vals).__name__}; use "
                "a list, numpy array, pandas Series or Index.")

    if qobs is not None:
        if isinstance(qobs, (list, np.ndarray, pd.Series)):
            try:
                qobs = np.array(qobs, dtype=np.float64)
            except (ValueError, TypeError):
                raise ValueError(
                    "Observed discharge could not be cast to float — it "
                    "contains non-numeric entries.")
        else:
            raise ValueError(
                f"Unsupported 'qobs' container {type(qobs).__name__}; use "
                "a list, numpy array or pandas Series.")
        if qobs.ndim != 1:
            raise ValueError(
                f"Observed discharge must be a flat series; got "
                f"ndim={qobs.ndim}.")

    q05, q25, q75, q95 = np.percentile(qsim, [5, 25, 75, 95], axis=1)

    if x_vals is None:
        x_vals = np.arange(qsim.shape[0])

    fig, ax = plt.subplots(1)
    ax.plot(x_vals, np.mean(qsim, axis=1), color='red', label="Qsim mean",
            lw=0.5)
    if qobs is not None:
        ax.plot(x_vals, qobs, color='blue', label="Qobs", lw=0.5)

    ax.fill_between(x_vals, q05, q95, color=(1, 0, 0, 0.3),
                    label="5%/95% quantile")
    ax.fill_between(x_vals, q25, q75, color=(1, 0, 0, 0.1),
                    label="25%/75% quantile")
    ax.legend()

    return fig, ax


def plot_sensitivity(result):
    """Bar chart of sensitivity indices with their uncertainty.

    Accepts either result type of :mod:`rrmpg_jax.tools.sensitivity`:
    a :class:`~rrmpg_jax.tools.sensitivity.SobolResult` plots S1 and ST
    side by side with the bootstrap CIs as error bars; a
    :class:`~rrmpg_jax.tools.sensitivity.MorrisResult` plots mu* with
    its CI plus sigma.

    Returns:
        ``(fig, ax)`` matplotlib handles.

    Raises:
        TypeError: for inputs that are neither result type.
    """
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(1)
    if hasattr(result, "s1"):
        dim = len(result.s1)
        names = result.names or [str(i) for i in range(dim)]
        pos = np.arange(dim)
        ax.bar(pos - 0.2, result.s1, width=0.4, yerr=result.s1_conf,
               label="S1 (first order)", capsize=3)
        ax.bar(pos + 0.2, result.st, width=0.4, yerr=result.st_conf,
               label="ST (total order)", capsize=3)
        ax.set_ylabel("Sobol' index")
    elif hasattr(result, "mu_star"):
        dim = len(result.mu_star)
        names = result.names or [str(i) for i in range(dim)]
        pos = np.arange(dim)
        ax.bar(pos - 0.2, result.mu_star, width=0.4,
               yerr=result.mu_star_conf, label="mu* (importance)",
               capsize=3)
        ax.bar(pos + 0.2, result.sigma, width=0.4,
               label="sigma (interaction)")
        ax.set_ylabel("elementary effect")
    else:
        raise TypeError(
            "plot_sensitivity expects a SobolResult or MorrisResult; "
            f"got {type(result).__name__}.")
    ax.set_xticks(pos)
    ax.set_xticklabels(names)
    ax.legend()
    return fig, ax


def plot_pareto_front(result, labels=("objective 1", "objective 2")):
    """Scatter a bi-objective Pareto front over its final population.

    Args:
        result: a :class:`~rrmpg_jax.tools.moo.ParetoResult` with two
            objectives.
        labels: axis labels for the two objectives.

    Returns:
        ``(fig, ax)`` matplotlib handles.

    Raises:
        ValueError: for results with other than two objectives.
    """
    import matplotlib.pyplot as plt

    f = np.asarray(result.f)
    if f.ndim != 2 or f.shape[1] != 2:
        raise ValueError(
            "plot_pareto_front draws bi-objective fronts; got objective "
            f"array of shape {f.shape}. Slice two columns for higher-"
            "dimensional problems.")
    fig, ax = plt.subplots(1)
    pop_f = np.asarray(result.population_f)
    dominated = np.asarray(result.rank) > 0
    if dominated.any():
        ax.scatter(pop_f[dominated, 0], pop_f[dominated, 1], s=10,
                   color="0.7", label="dominated population")
    order = np.argsort(f[:, 0])
    ax.plot(f[order, 0], f[order, 1], "o-", color="red", ms=4, lw=0.8,
            label="Pareto front")
    ax.set_xlabel(labels[0])
    ax.set_ylabel(labels[1])
    ax.legend()
    return fig, ax


def plot_assimilation(diags, x_vals=None):
    """Innovation and spread/ESS trajectories of an assimilation run.

    Args:
        diags: an :class:`~rrmpg_jax.tools.assimilation.EnKFDiagnostics`
            from :func:`~rrmpg_jax.tools.assimilation.assimilation_cycle`.
        x_vals: (optional) x-axis values per cycle (e.g. dates).

    Returns:
        ``(fig, (ax_innov, ax_spread))`` matplotlib handles.
    """
    import matplotlib.pyplot as plt

    innov = np.asarray(diags.innovation)[:, 0]
    if x_vals is None:
        x_vals = np.arange(len(innov))
    fig, (ax1, ax2) = plt.subplots(2, sharex=True)
    ax1.axhline(0.0, color="0.8", lw=0.8)
    ax1.plot(x_vals, innov, "o-", ms=3, lw=0.8, color="blue",
             label="innovation (obs - forecast mean)")
    ax1.legend()
    if diags.ess is not None:
        ax2.plot(x_vals, np.asarray(diags.ess), "o-", ms=3, lw=0.8,
                 color="green", label="effective sample size")
    else:
        ax2.plot(x_vals, np.asarray(diags.prior_spread), "o-", ms=3,
                 lw=0.8, color="red", label="prior ensemble spread")
    ax2.legend()
    ax2.set_xlabel("assimilation cycle")
    return fig, (ax1, ax2)
