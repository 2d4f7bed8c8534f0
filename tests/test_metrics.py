"""Metric tests (reference parity, ``test/test_utils.py:19-97``) plus
batched-jittable equivalence checks."""

import numpy as np
import pytest

from rrmpg_jax.utils import (
    calc_alpha_nse,
    calc_beta_nse,
    calc_kge,
    calc_mse,
    calc_nse,
    calc_r,
    calc_rmse,
    check_for_negatives,
    kge,
    mse,
    nse,
    pearson_r,
    rmse,
    validate_array_input,
)


def test_nse_perfect_fit():
    obs = np.random.uniform(0, 10, 100)
    assert calc_nse(obs, obs) == 1.0


def test_nse_mean_prediction_zero():
    obs = np.arange(10, dtype=np.float64)
    sim = np.full(10, np.mean(obs))
    assert calc_nse(obs, sim) == 0.0


def test_nse_constant_obs_raises():
    with pytest.raises(RuntimeError):
        calc_nse(np.ones(10), np.random.uniform(0, 1, 10))


def test_rmse_and_mse():
    obs = np.array([1.0, 2.0, 3.0])
    sim = np.array([2.0, 3.0, 4.0])
    assert calc_mse(obs, sim) == 1.0
    assert calc_rmse(obs, sim) == 1.0
    assert calc_rmse(obs, obs) == 0.0


def test_size_mismatch_raises():
    for fn in (calc_nse, calc_rmse, calc_mse, calc_kge):
        with pytest.raises(ValueError):
            fn(np.ones(3), np.ones(4))


def test_kge_perfect_fit():
    obs = np.random.uniform(1, 10, 100)
    assert np.isclose(calc_kge(obs, obs), 1.0)


def test_kge_zero_mean_raises():
    obs = np.concatenate([np.ones(5), -np.ones(5)])
    with pytest.raises(RuntimeError):
        calc_kge(obs, np.random.uniform(0, 1, 10))


def test_alpha_beta_nse():
    obs = np.random.uniform(1, 10, 200)
    sim = 2 * obs
    assert np.isclose(calc_alpha_nse(obs, sim), 2.0)
    assert np.isclose(calc_beta_nse(obs, sim),
                      np.mean(obs) / np.std(obs))


def test_calc_r_matches_scipy():
    obs = np.random.uniform(0, 10, 50)
    sim = obs + np.random.normal(0, 1, 50)
    r, p = calc_r(obs, sim)
    from scipy.stats import pearsonr
    r_ref, p_ref = pearsonr(obs, sim)
    assert np.isclose(r, r_ref)
    assert np.isclose(p, p_ref)


def test_jittable_metrics_match_validated():
    obs = np.random.uniform(1, 10, 300)
    sim = obs + np.random.normal(0, 0.5, 300)
    assert np.isclose(float(mse(obs, sim)), calc_mse(obs, sim))
    assert np.isclose(float(rmse(obs, sim)), calc_rmse(obs, sim))
    assert np.isclose(float(nse(obs, sim)), calc_nse(obs, sim))
    assert np.isclose(float(kge(obs, sim)), calc_kge(obs, sim))
    assert np.isclose(float(pearson_r(obs, sim)), calc_r(obs, sim)[0])


def test_jittable_metrics_batched():
    obs = np.random.uniform(1, 10, 300)
    sims = np.stack([obs + np.random.normal(0, s, 300)
                     for s in (0.1, 0.5, 1.0)])
    batched = np.asarray(nse(obs[None, :], sims, axis=-1))
    assert batched.shape == (3,)
    for i in range(3):
        assert np.isclose(batched[i], calc_nse(obs, sims[i]))


def test_check_for_negatives():
    assert check_for_negatives([-1, 0, 1])
    assert not check_for_negatives([0, 1, 2])
    assert not check_for_negatives([])


def test_validate_array_input():
    out = validate_array_input([1, 2, 3], np.float64, 'x')
    assert out.dtype == np.float64 and out.shape == (3,)
    out = validate_array_input(np.ones((2, 2)), np.float64, 'x')
    assert out.shape == (4,)  # flattened
    import pandas as pd
    out = validate_array_input(pd.Series([1.0, 2.0]), np.float64, 'x')
    assert isinstance(out, np.ndarray)
    with pytest.raises(TypeError):
        validate_array_input("abc", np.float64, 'x')
    with pytest.raises(ValueError):
        validate_array_input(['a', 'b'], np.float64, 'x')
