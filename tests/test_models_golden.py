"""Golden-data validation: simulated discharge must match the original
implementations (authors' Excel sheets / MATLAB code) allclose.

This is the core correctness contract, mirroring the reference's test
strategy (``test/test_models.py:107-356``), exercised through the public
model-class API (validation + preprocessing + batched kernels).
"""

import os

import numpy as np
import pandas as pd
import pytest

from rrmpg_jax.models import (
    Cemaneige,
    CemaneigeGR4J,
    CemaneigeHystGR4J,
    CemaneigeHystGR4JIce,
    GR4J,
    HBVEdu,
)

DATA_DIR = os.path.join(os.path.dirname(__file__), 'data')

ALTITUDES = [550, 620, 700, 785, 920]


def _data(name):
    return os.path.join(DATA_DIR, name)


def test_hbvedu_against_matlab():
    daily = pd.read_csv(_data('hbv_daily_inputs.txt'), sep='\t',
                        names=['date', 'month', 'temp', 'prec'])
    monthly = pd.read_csv(_data('hbv_monthly_inputs.txt'), sep=' ',
                          names=['temp', 'not_needed', 'evap'])
    qsim_matlab = pd.read_csv(_data('hbv_qsim.csv'), header=None,
                              names=['qsim'])

    params = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
    model = HBVEdu(params=params)

    area = 410
    qsim = model.simulate(temp=daily.temp, prec=daily.prec,
                          month=daily.month, PE_m=monthly.evap,
                          T_m=monthly.temp, snow_init=0, soil_init=100,
                          s1_init=3, s2_init=10, return_storage=False)
    qsim = (qsim * area * 1000) / (24 * 60 * 60)
    assert np.allclose(qsim.flatten(), qsim_matlab.qsim)


def test_gr4j_against_excel():
    params = {'x1': np.exp(5.76865628090826),
              'x2': np.sinh(1.61742503661094),
              'x3': np.exp(4.24316129943456),
              'x4': np.exp(-0.117506799276908) + 0.5}
    model = GR4J(params=params)
    data = pd.read_csv(_data('gr4j_example_data.csv'), sep=',')
    qsim = model.simulate(data.prec, data.etp, s_init=0.6, r_init=0.7,
                          return_storage=False)
    assert np.allclose(qsim.flatten(), data.qsim_excel)


def test_cemaneige_against_excel():
    model = Cemaneige(params={'CTG': 0.25, 'Kf': 3.74})
    df = pd.read_csv(_data('cemaneige_validation_data.csv'), sep=';')
    qsim = model.simulate(df.precipitation, df.mean_temp, df.min_temp,
                          df.max_temp, met_station_height=495,
                          altitudes=ALTITUDES)
    assert np.allclose(qsim.flatten(), df.liquid_outflow.to_numpy())


def test_cemaneigegr4j_against_excel():
    params = {'CTG': 0.25, 'Kf': 3.74,
              'x1': np.exp(5.25483021675164),
              'x2': np.sinh(1.58209470624126),
              'x3': np.exp(4.3853181982412),
              'x4': np.exp(0.954786342674327) + 0.5}
    model = CemaneigeGR4J(params=params)
    df = pd.read_csv(_data('cemaneigegr4j_validation_data.csv'), sep=';',
                     index_col=0)
    qsim = model.simulate(df.precipitation, df.mean_temp, df.min_temp,
                          df.max_temp, df.pe, met_station_height=495,
                          altitudes=ALTITUDES, s_init=0.6, r_init=0.7)
    assert np.allclose(qsim.flatten(), df.qsim.to_numpy())


HYST_PARAMS = {"Thacc": 18.6, "Rsp": 0.22, "CTG": 0.78, "Kf": 4.02,
               "x1": 546, "x2": 0.53, "x3": 276, "x4": 1.32}


@pytest.mark.f64only  # hysteresis melt branches (eTG == 0 exact
# compare) flip under float32 roundoff; golden parity is a float64
# contract (drift is quantified in test_precision.py)
def test_cemaneigehystgr4j_against_excel():
    model = CemaneigeHystGR4J(params=HYST_PARAMS)
    df = pd.read_csv(_data('cemaneigehystgr4j_validation_data.csv'),
                     index_col=0)
    qsim = model.simulate(df.precipitation, df.mean_temp, df.min_temp,
                          df.max_temp, df.pe, met_station_height=700,
                          altitudes=ALTITUDES, s_init=0.5, r_init=0.4)
    assert np.allclose(qsim.flatten(), df.qsim.to_numpy())


@pytest.mark.f64only  # hysteresis melt branches (eTG == 0 exact
# compare) flip under float32 roundoff; golden parity is a float64
# contract (drift is quantified in test_precision.py)
def test_cemaneigehystgr4jice_against_excel():
    model = CemaneigeHystGR4JIce(params=dict(HYST_PARAMS, DDF=5))
    df = pd.read_csv(_data('cemaneigehystgr4jice_validation_data.csv'),
                     index_col=0)
    frac_ice = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
    qsim = model.simulate(df.precipitation, df.mean_temp, df.min_temp,
                          df.max_temp, df.pe, frac_ice,
                          met_station_height=700, altitudes=ALTITUDES,
                          s_init=0.5, r_init=0.4, sca_init=0.2)
    assert np.allclose(qsim.flatten(), df.qsim.to_numpy())


def test_cemaneigehystgr4jice_storages_shapes():
    model = CemaneigeHystGR4JIce(params=dict(HYST_PARAMS, DDF=5))
    df = pd.read_csv(_data('cemaneigehystgr4jice_validation_data.csv'),
                     index_col=0)
    frac_ice = np.array([0.02, 0.04, 0.25, 0.51, 0.71])
    out = model.simulate(df.precipitation, df.mean_temp, df.min_temp,
                         df.max_temp, df.pe, frac_ice,
                         met_station_height=700, altitudes=ALTITUDES,
                         s_init=0.5, r_init=0.4, sca_init=0.2,
                         return_storage=True)
    # (qsim, G, eTG, s_store, r_store, sca, ice_melt, snowmelt, rain)
    T, L = len(df), len(ALTITUDES)
    shapes = [o.shape for o in out]
    assert shapes == [(T, 1), (T, L, 1), (T, L, 1), (T, 1), (T, 1),
                      (T, L, 1), (T, 1), (T, 1), (T, L, 1)]
