"""Ensemble plotting tests (headless backend)."""

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest

from rrmpg_jax.utils.plot_utils import plot_qsim_range


def test_plot_qsim_range_basic():
    qsim = np.random.uniform(0, 5, (100, 30))
    fig, ax = plot_qsim_range(qsim)
    assert len(ax.lines) == 1
    assert len(ax.collections) == 2  # two quantile bands


def test_plot_qsim_range_with_obs_and_x():
    qsim = np.random.uniform(0, 5, (50, 10))
    qobs = np.random.uniform(0, 5, 50)
    x = np.arange(50)
    fig, ax = plot_qsim_range(qsim, x_vals=x, qobs=qobs)
    assert len(ax.lines) == 2


def test_plot_qsim_range_errors():
    with pytest.raises(ValueError):
        plot_qsim_range(np.zeros(10))  # not 2-D
    with pytest.raises(ValueError):
        plot_qsim_range(np.zeros((10, 3)), qobs=np.zeros((5, 2)))
    with pytest.raises(ValueError):
        plot_qsim_range(np.zeros((10, 3)), x_vals="dates")


def test_plot_sensitivity_sobol_and_morris():
    from rrmpg_jax.tools.sensitivity import MorrisResult, SobolResult
    from rrmpg_jax.utils.plot_utils import plot_sensitivity

    sob = SobolResult(s1=np.array([0.3, 0.5]), st=np.array([0.4, 0.6]),
                      s1_conf=np.array([0.02, 0.03]),
                      st_conf=np.array([0.02, 0.03]), mean=1.0, var=2.0,
                      n=64, n_used=64, nfev=256, names=('a', 'b'))
    fig, ax = plot_sensitivity(sob)
    assert len(ax.patches) == 4  # 2 params x 2 index families

    mor = MorrisResult(mu=np.array([1.0, -2.0]),
                       mu_star=np.array([1.0, 2.0]),
                       sigma=np.array([0.1, 0.4]),
                       mu_star_conf=np.array([0.05, 0.1]),
                       n_effects=np.array([8, 8]), nfev=24, names=None)
    fig, ax = plot_sensitivity(mor)
    assert len(ax.patches) == 4

    with pytest.raises(TypeError):
        plot_sensitivity({"not": "a result"})


def test_plot_pareto_front():
    from rrmpg_jax.tools.moo import ParetoResult
    from rrmpg_jax.utils.plot_utils import plot_pareto_front

    f1 = np.linspace(0, 1, 5)
    front = np.column_stack([f1, 1 - f1])
    pop_f = np.vstack([front, front + 0.3])
    res = ParetoResult(x=np.zeros((5, 3)), f=front,
                       population=np.zeros((10, 3)), population_f=pop_f,
                       rank=np.array([0] * 5 + [1] * 5), nit=3, nfev=40)
    fig, ax = plot_pareto_front(res, labels=("L_q", "L_sca"))
    assert len(ax.lines) == 1 and len(ax.collections) == 1

    bad = res._replace(f=np.zeros((5, 3)))
    with pytest.raises(ValueError):
        plot_pareto_front(bad)


def test_plot_assimilation():
    from rrmpg_jax.tools.assimilation import EnKFDiagnostics
    from rrmpg_jax.utils.plot_utils import plot_assimilation

    diags = EnKFDiagnostics(innovation=np.random.normal(0, 1, (12, 1)),
                            prior_spread=np.random.uniform(0, 1, 12),
                            posterior_mean=np.zeros((12, 4)))
    fig, (ax1, ax2) = plot_assimilation(diags)
    assert ax1.lines and ax2.lines

    diags_pf = diags._replace(ess=np.random.uniform(1, 64, 12))
    fig, (ax1, ax2) = plot_assimilation(diags_pf)
    assert ax2.lines
