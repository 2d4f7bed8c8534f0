"""monte_carlo(return_qsim=False): trajectory-free Monte-Carlo.

With ``engine='pallas'`` and stats-derivable metrics the evaluation
runs through the fused sufficient-statistics kernels (four floats per
member to HBM, no trajectories anywhere); otherwise the trajectory
path runs but never retains qsim host-side.  Both must agree with the
default trajectory evaluation.
"""

import numpy as np
import pytest

from rrmpg_jax.models import GR4J, CemaneigeHystGR4JIce, HBVEdu
from rrmpg_jax.tools import monte_carlo

from lane import tol

ALTS = [550, 620, 700, 785, 920]
FRAC_ICE = [0.02, 0.04, 0.25, 0.51, 0.71]


@pytest.fixture(scope="module")
def gr4j_data():
    rng = np.random.default_rng(11)
    T = 200
    return {'prec': rng.uniform(0, 15, T), 'etp': rng.uniform(0, 4, T),
            'qobs': rng.uniform(0.5, 5, T)}


def test_gr4j_fused_stats_matches_trajectory(gr4j_data):
    d = gr4j_data
    metrics = ('mse', 'rmse', 'nse', 'kge', 'alpha_nse', 'beta_nse', 'r')
    model = GR4J()
    # get_random_params is driven by numpy's global state, so fixing the
    # global seed before each call makes both paths sample identical
    # parameter sets.
    np.random.seed(123)
    r_traj = monte_carlo(model, 16, qobs=d['qobs'], prec=d['prec'],
                         etp=d['etp'], metrics=metrics)
    np.random.seed(123)
    r_fast = monte_carlo(model, 16, qobs=d['qobs'], prec=d['prec'],
                         etp=d['etp'], metrics=metrics,
                         return_qsim=False, engine='pallas',
                         interpret=True)
    assert 'qsim' not in r_fast
    np.testing.assert_array_equal(
        np.asarray(r_fast['params'].tolist()),
        np.asarray(r_traj['params'].tolist()))
    for m in metrics:
        ok = np.isfinite(r_traj[m])
        np.testing.assert_allclose(r_fast[m][ok], r_traj[m][ok],
                                   rtol=tol(1e-9, 2e-3),
                                   atol=tol(1e-11, 1e-3), err_msg=m)


def test_return_qsim_false_without_stats_path(gr4j_data):
    """XLA engine: trajectories are computed but never retained."""
    d = gr4j_data
    np.random.seed(7)
    r = monte_carlo(GR4J(), 8, qobs=d['qobs'], prec=d['prec'],
                    etp=d['etp'], return_qsim=False)
    assert 'qsim' not in r and 'mse' in r
    np.random.seed(7)
    r_ref = monte_carlo(GR4J(), 8, qobs=d['qobs'], prec=d['prec'],
                        etp=d['etp'])
    np.testing.assert_allclose(r['mse'], r_ref['mse'])
    # fdc metrics are not stats-derivable: the fused path must not
    # engage, and results still match the trajectory reduction.
    np.random.seed(7)
    r_fdc = monte_carlo(GR4J(), 8, qobs=d['qobs'], prec=d['prec'],
                        etp=d['etp'], metrics=('mse', 'fhv'),
                        return_qsim=False, engine='pallas',
                        interpret=True)
    assert np.isfinite(r_fdc['fhv']).any()


def test_return_qsim_false_needs_qobs(gr4j_data):
    with pytest.raises(ValueError, match="qobs"):
        monte_carlo(GR4J(), 4, prec=gr4j_data['prec'],
                    etp=gr4j_data['etp'], return_qsim=False)


@pytest.mark.slow  # 19 s: over the quick tier's >15 s rule
def test_batched_fused_stats(gr4j_data):
    """batch_size chunks compose with the fused statistics path."""
    d = gr4j_data
    np.random.seed(5)
    r1 = monte_carlo(GR4J(), 12, qobs=d['qobs'], prec=d['prec'],
                     etp=d['etp'], return_qsim=False, engine='pallas',
                     interpret=True)
    np.random.seed(5)
    r2 = monte_carlo(GR4J(), 12, qobs=d['qobs'], prec=d['prec'],
                     etp=d['etp'], return_qsim=False, engine='pallas',
                     interpret=True, batch_size=5)
    np.testing.assert_allclose(r2['mse'], r1['mse'],
                               rtol=tol(1e-12, 1e-5))


@pytest.mark.slow
def test_hbv_and_snow_fused_stats_match_trajectory():
    rng = np.random.default_rng(3)
    T = 150
    qobs = rng.uniform(0.5, 5, T)

    # HBV-Edu
    hbv_kw = dict(temp=rng.uniform(-10, 20, T),
                  prec=rng.uniform(0, 15, T),
                  month=rng.integers(1, 13, T),
                  PE_m=rng.uniform(1, 4, 12),
                  T_m=rng.uniform(-5, 15, 12))
    np.random.seed(21)
    r_traj = monte_carlo(HBVEdu(), 8, qobs=qobs, **hbv_kw)
    np.random.seed(21)
    r_fast = monte_carlo(HBVEdu(), 8, qobs=qobs, return_qsim=False,
                         engine='pallas', interpret=True, **hbv_kw)
    ok = np.isfinite(r_traj['mse'])  # negative-soil members are NaN
    np.testing.assert_allclose(r_fast['mse'][ok], r_traj['mse'][ok],
                               rtol=tol(1e-9, 2e-3),
                               atol=tol(1e-11, 1e-3))

    # Flagship snow composition
    mt = rng.uniform(-10, 15, T)
    snow_kw = dict(prec=rng.uniform(0, 15, T), mean_temp=mt,
                   min_temp=mt - 2.0, max_temp=mt + 2.0,
                   etp=rng.uniform(0, 4, T), frac_ice=FRAC_ICE,
                   met_station_height=495, altitudes=ALTS)
    np.random.seed(22)
    r_traj = monte_carlo(CemaneigeHystGR4JIce(), 8, qobs=qobs,
                         metrics=('mse', 'kge'), **snow_kw)
    np.random.seed(22)
    r_fast = monte_carlo(CemaneigeHystGR4JIce(), 8, qobs=qobs,
                         metrics=('mse', 'kge'), return_qsim=False,
                         engine='pallas', interpret=True, **snow_kw)
    for m in ('mse', 'kge'):
        ok = np.isfinite(r_traj[m])
        np.testing.assert_allclose(r_fast[m][ok], r_traj[m][ok],
                                   rtol=tol(1e-9, 2e-3),
                                   atol=tol(1e-11, 1e-3), err_msg=m)
