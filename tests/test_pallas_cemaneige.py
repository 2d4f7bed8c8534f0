"""Standalone-Cemaneige pallas engine parity (snow-only family kernel)."""

import numpy as np
import pytest

from lane import tol

from rrmpg_jax.models import Cemaneige

ALTITUDES = [550., 620., 700., 785., 920.]
STATION = 495.0


def _met(T=300, seed=7):
    rng = np.random.default_rng(seed)
    mean_t = rng.uniform(-8, 15, T)
    return dict(prec=rng.uniform(0, 20, T), mean_temp=mean_t,
                min_temp=mean_t - rng.uniform(0, 5, T),
                max_temp=mean_t + rng.uniform(0, 5, T),
                met_station_height=STATION, altitudes=ALTITUDES)


def test_cemaneige_class_pallas_engine_matches_xla():
    model = Cemaneige()
    params = model.get_random_params(num=4)
    kwargs = _met()
    out_x = model.simulate(params=params, snow_pack_init=1.0, **kwargs)
    out_p = model.simulate(params=params, snow_pack_init=1.0,
                           engine="pallas", interpret=True, **kwargs)
    assert out_p.shape == out_x.shape
    assert np.allclose(out_p, out_x, rtol=1e-6, atol=1e-8)


def test_cemaneige_pallas_rejects_storages():
    with pytest.raises(ValueError):
        Cemaneige().simulate(params=None, return_storages=True,
                             engine="pallas", **_met(50))


@pytest.mark.slow
def test_cemaneige_fit_pallas_engine_smoke():
    model = Cemaneige(params={'CTG': 0.3, 'Kf': 4.0})
    kwargs = _met(250)
    obs = model.simulate(**kwargs).flatten()
    res = Cemaneige().fit(obs, seed=0, maxiter=2, engine="pallas",
                          interpret=True, **kwargs)
    assert np.isfinite(res.fun)


@pytest.mark.slow
def test_composition_class_pallas_interpret():
    # The interpret= plumbing through the composition class API (the CPU
    # CI gap flagged in round 1): CemaneigeGR4J simulate via both engines.
    from rrmpg_jax.models import CemaneigeGR4J

    model = CemaneigeGR4J()
    params = model.get_random_params(num=2)
    rng = np.random.default_rng(11)
    T = 250
    mean_t = rng.uniform(-8, 15, T)
    kwargs = dict(prec=rng.uniform(0, 20, T), mean_temp=mean_t,
                  min_temp=mean_t - 2.0, max_temp=mean_t + 2.0,
                  etp=rng.uniform(0, 4, T),
                  met_station_height=STATION, altitudes=ALTITUDES)
    q_x = model.simulate(params=params, **kwargs)
    q_p = model.simulate(params=params, engine="pallas", interpret=True,
                         **kwargs)
    assert np.allclose(q_p, q_x, rtol=tol(1e-5, 1e-3),
                       atol=tol(1e-7, 1e-3))


@pytest.mark.slow
def test_all_composition_classes_pallas_interpret():
    # Class-level engine parity for the remaining composition classes
    # (CemaneigeGR4J is covered above).
    from rrmpg_jax.models import (CemaneigeGR4JIce, CemaneigeHystGR4J,
                                  CemaneigeHystGR4JIce)

    rng = np.random.default_rng(23)
    T = 200
    mean_t = rng.uniform(-8, 15, T)
    kwargs = dict(prec=rng.uniform(0, 20, T), mean_temp=mean_t,
                  min_temp=mean_t - 2.0, max_temp=mean_t + 2.0,
                  etp=rng.uniform(0, 4, T),
                  met_station_height=STATION, altitudes=ALTITUDES)
    fi = np.asarray([0.1, 0.2, 0.3, 0.4, 0.5])

    for cls, extra in ((CemaneigeGR4JIce, dict(frac_ice=fi)),
                       (CemaneigeHystGR4J, dict(sca_init=0.2)),
                       (CemaneigeHystGR4JIce,
                        dict(frac_ice=fi, sca_init=0.2))):
        model = cls()
        params = model.get_random_params(num=2)
        q_x = model.simulate(params=params, **kwargs, **extra)
        q_p = model.simulate(params=params, engine="pallas",
                             interpret=True, **kwargs, **extra)
        assert np.allclose(q_p, q_x, rtol=tol(1e-5, 1e-3),
                           atol=tol(1e-7, 1e-3)), cls.__name__
