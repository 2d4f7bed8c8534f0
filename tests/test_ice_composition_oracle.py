"""API-level oracle validation for CemaneigeGR4JIce.

The reference ships no golden data for this class (SURVEY.md section 4);
here the full class API (validation + extrapolation + batched kernel) is
cross-checked against a composition of the independent C++ oracle
kernels.
"""

import numpy as np
import pytest

from rrmpg_jax import native
from rrmpg_jax.models import CemaneigeGR4JIce
from rrmpg_jax.ops import (
    calculate_solid_fraction,
    extrapolate_precipitation,
    extrapolate_temperature,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable")


def test_cemaneigegr4jice_class_vs_cpp_oracle():
    rng = np.random.default_rng(17)
    T = 600
    prec = rng.uniform(0, 15, T)
    mean_t = rng.uniform(-10, 12, T)
    min_t = mean_t - rng.uniform(0, 5, T)
    max_t = mean_t + rng.uniform(0, 5, T)
    etp = rng.uniform(0, 4, T)
    altitudes = [550, 620, 700, 785, 920]
    station = 495
    frac_ice = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
    params = {'CTG': 0.3, 'Kf': 4.0, 'x1': 310.0, 'x2': 0.9, 'x3': 95.0,
              'x4': 2.2, 'DDF': 6.0}

    qsim = CemaneigeGR4JIce(params=params).simulate(
        prec, mean_t, min_t, max_t, etp, frac_ice,
        met_station_height=station, altitudes=altitudes, s_init=0.4,
        r_init=0.3)[:, 0]

    # Oracle composition: met preprocessing (jnp, validated elsewhere)
    # feeding the chained C++ kernels.
    alts = np.asarray(altitudes, np.float64)
    prec_l = np.asarray(extrapolate_precipitation(prec, alts, station))
    min_l, mean_l, max_l = (np.asarray(a) for a in extrapolate_temperature(
        min_t, mean_t, max_t, alts, station))
    frac = np.asarray(calculate_solid_fraction(prec_l, alts, mean_l,
                                               min_l, max_l))
    snowmelt, G, _ = native.oracle_cemaneige(prec_l, mean_l, frac, 0.0,
                                             0.0, params)
    icemelt = native.oracle_icemelt(mean_l, G, params)
    liquid = snowmelt + np.sum(icemelt * frac_ice[None, :], axis=1)
    q_ref, _, _ = native.oracle_gr4j(liquid, etp, 0.4, 0.3, params)

    assert np.allclose(qsim, q_ref)
