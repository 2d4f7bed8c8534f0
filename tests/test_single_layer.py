"""Single-layer path: snow models without elevation bands.

With ``altitudes=[]`` the reference expands the station series to one
elevation layer at station height (``rrmpg/models/cemaneige.py:190-198``);
this branch is not covered by the golden CSVs (which all use 5 bands).
"""

import numpy as np
import pytest

from rrmpg_jax.models import Cemaneige, CemaneigeGR4J
from rrmpg_jax.ops import calculate_solid_fraction, run_cemaneige


def _met(T=300, seed=8):
    rng = np.random.default_rng(seed)
    prec = rng.uniform(0, 12, T)
    mean_t = rng.uniform(-8, 12, T)
    return prec, mean_t, mean_t - 3, mean_t + 3, rng.uniform(0, 3, T)


def test_cemaneige_single_layer_matches_manual_kernel():
    prec, mean_t, min_t, max_t, _ = _met()
    params = {'CTG': 0.3, 'Kf': 4.0}
    out = Cemaneige(params=params).simulate(
        prec, mean_t, min_t, max_t, met_station_height=500)

    # Manual single-layer kernel run: no extrapolation, station series as
    # the one layer.
    pl = prec[:, None]
    ml = mean_t[:, None]
    frac = np.asarray(calculate_solid_fraction(
        pl, np.array([500.0]), ml, min_t[:, None], max_t[:, None]))
    ref, _, _ = run_cemaneige(pl, ml, frac, 0.0, 0.0, params)
    assert out.shape == (300, 1)
    assert np.allclose(out[:, 0], np.asarray(ref))


def test_cemaneige_single_layer_storages_shape():
    prec, mean_t, min_t, max_t, _ = _met(seed=9)
    out, G, eTG = Cemaneige().simulate(
        prec, mean_t, min_t, max_t, met_station_height=500,
        return_storages=True)
    assert G.shape == (300, 1, 1)


def test_cemaneigegr4j_single_layer_runs():
    prec, mean_t, min_t, max_t, etp = _met(seed=10)
    qsim = CemaneigeGR4J().simulate(prec, mean_t, min_t, max_t, etp,
                                    met_station_height=500)
    assert qsim.shape == (300, 1)
    assert np.isfinite(qsim).all()


def test_altitudes_must_be_list():
    prec, mean_t, min_t, max_t, _ = _met(seed=11)
    with pytest.raises(TypeError):
        Cemaneige().simulate(prec, mean_t, min_t, max_t,
                             met_station_height=500,
                             altitudes=np.array([500, 700]))
