"""GLUE uncertainty-quantification tests."""

import numpy as np
import pytest

from rrmpg_jax.tools.uncertainty import glue_weights, prediction_limits


def test_glue_weights_behavioral_cut():
    scores = np.array([0.8, 0.4, -0.2, np.nan, 0.0])
    w = glue_weights(scores, behavioral_threshold=0.0)
    assert w[2] == 0.0 and w[3] == 0.0 and w[4] == 0.0
    assert w[0] > w[1] > 0.0
    assert np.isclose(w.sum(), 1.0)


def test_glue_weights_loss_direction():
    losses = np.array([0.1, 0.5, 2.0])
    w = glue_weights(losses, behavioral_threshold=1.0,
                     higher_is_better=False)
    assert w[2] == 0.0 and w[0] > w[1] > 0.0


def test_prediction_limits_weighted_quantiles():
    rng = np.random.default_rng(0)
    T, N = 50, 400
    centers = rng.normal(5.0, 1.0, N)
    qsim = centers[None, :] + rng.normal(0, 0.01, (T, N))
    # Weight only members near 5.0 heavily.
    scores = -np.abs(centers - 5.0)
    w = glue_weights(scores, behavioral_threshold=-0.5)
    lo, med, hi = prediction_limits(qsim, w, quantiles=(0.05, 0.5, 0.95))
    assert lo.shape == (T,)
    assert np.all(lo <= med + 1e-6) and np.all(med <= hi + 1e-6)
    # Median of the behavioral band sits near 5.
    assert abs(med.mean() - 5.0) < 0.2
    # Bands are inside the behavioral window.
    assert lo.mean() > 4.3 and hi.mean() < 5.7


def test_prediction_limits_rejects_empty_behavioral():
    with pytest.raises(ValueError):
        prediction_limits(np.ones((10, 3)), np.zeros(3))


def test_glue_end_to_end_with_monte_carlo():
    from rrmpg_jax.models import ABCModel
    from rrmpg_jax.tools import monte_carlo

    truth = ABCModel(params={'a': 0.4, 'b': 0.2, 'c': 0.3})
    prec = np.random.default_rng(1).uniform(0, 15, 400)
    qobs = truth.simulate(prec).flatten()
    mc = monte_carlo(ABCModel(), 256, qobs=qobs, prec=prec,
                     metrics=('nse',))
    w = glue_weights(mc['nse'], behavioral_threshold=0.0)
    assert w.sum() > 0
    lo, hi = prediction_limits(mc['qsim'], w, quantiles=(0.05, 0.95))
    # Observed discharge mostly inside the 90% band.
    coverage = np.mean((qobs >= lo) & (qobs <= hi))
    assert coverage > 0.5


def test_prediction_limits_time_chunked_matches():
    """Time-chunked weighted quantiles equal the single-program result
    (per-timestep independence), including a remainder chunk."""
    rng = np.random.default_rng(3)
    qsim = rng.uniform(0, 10, (103, 50))
    w = rng.uniform(0, 1, 50)
    w /= w.sum()
    full = prediction_limits(qsim, w)
    chunked = prediction_limits(qsim, w, batch_size=40)
    assert np.array_equal(full, chunked)
    with pytest.raises(TypeError, match="batch_size"):
        prediction_limits(qsim, w, batch_size=0)
