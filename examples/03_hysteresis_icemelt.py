"""Hysteresis + ice-melt tutorial on the real Alpine catchment.

Mirrors the reference's Tutorial_Hysteresis_IceMelt notebook using the
same bundled 732-day Alpine dataset (``examples/data/hyst_ice_input.csv``,
discharge + five MODIS NDSI snow-cover bands), elevation bands and glacier
fractions.  Three model variants are calibrated exactly as in the
tutorial -- multi-objective Q+SCA with KGE loss for the hysteresis
variants, discharge-only MSE for the ice variant -- and evaluated by
discharge KGE.

Published reference results to compare against
(``Tutorial_Hysteresis_IceMelt.rst:204-209,524-526``):
fit_Q_SCA fun 0.1777 (nfev 14440); KGE Hyst+Ice 0.9133, Hyst 0.8765,
Ice 0.8541.
"""

import os

import numpy as np
import pandas as pd

from rrmpg_jax.models import (
    CemaneigeGR4JIce,
    CemaneigeHystGR4J,
    CemaneigeHystGR4JIce,
)
from rrmpg_jax.utils import calc_kge

ELEVATION = [2277.84423828125, 2641.563720703125, 2845.09521484375,
             3002.329833984375, 3227.36669921875]
MEAN_ELEV = 2798.84033203125
FRAC_ICE = np.array([0.022034026, 0.042062109, 0.246620231, 0.507329678,
                     0.709368134])

# CI fast mode (tests/test_examples.py): few-generation calibrations so
# the example executes end-to-end in seconds; the tutorial-quality
# calibration budget is the default.
FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def main():
    import jax
    engine = "pallas" if jax.devices()[0].platform == "gpu" else "xla"
    fit_kw = dict(maxiter=3) if FAST else {}

    path = os.path.join(os.path.dirname(__file__), "data",
                        "hyst_ice_input.csv")
    df = pd.read_csv(path, index_col="Date", sep=";", decimal=".",
                     parse_dates=["Date"])
    # Convert each MODIS NDSI band to snow-covered area before calibrating,
    # as the tutorial does (Tutorial_Hysteresis_IceMelt.rst:182-187):
    # SCA = 0.06 + 1.21 * NDSI, clipped at 100.
    ndsi = [(0.06 + 1.21 * df[f"NDSI{b}"]).clip(upper=100)
            for b in range(1, 6)]
    common = dict(met_station_height=MEAN_ELEV, altitudes=ELEVATION,
                  s_init=0.5, r_init=0.4)
    met = [df['P'], df['Tmean'], df['Tmin'], df['Tmax'], df['ET0']]

    results = {}

    # --- Hyst + Ice: multi-objective Q+SCA, KGE loss ---
    m1 = CemaneigeHystGR4JIce()
    res = m1.fit_Q_SCA(df["Qmm"], *met, FRAC_ICE, *ndsi,
                       loss_metric="kge", sca_init=0.2, seed=0,
                       engine=engine, **common, **fit_kw)
    m1.set_params(dict(zip(m1.get_parameter_names(), res.x)))
    qsim = m1.simulate(*met, FRAC_ICE, sca_init=0.2, **common).flatten()
    results["Hyst+Ice"] = (res, calc_kge(df["Qmm"].to_numpy(), qsim))

    # --- Hyst (no ice): multi-objective Q+SCA, KGE loss ---
    m2 = CemaneigeHystGR4J()
    res = m2.fit_Q_SCA(df["Qmm"], *met, *ndsi, loss_metric="kge",
                       sca_init=0.2, seed=0, engine=engine, **common,
                       **fit_kw)
    m2.set_params(dict(zip(m2.get_parameter_names(), res.x)))
    qsim = m2.simulate(*met, sca_init=0.2, **common).flatten()
    results["Hyst"] = (res, calc_kge(df["Qmm"].to_numpy(), qsim))

    # --- Ice (no hysteresis): discharge-only MSE ---
    m3 = CemaneigeGR4JIce()
    res = m3.fit(df["Qmm"], *met, FRAC_ICE, seed=0, engine=engine,
                 **common, **fit_kw)
    m3.set_params(dict(zip(m3.get_parameter_names(), res.x)))
    qsim = m3.simulate(*met, FRAC_ICE, **common).flatten()
    results["Ice"] = (res, calc_kge(df["Qmm"].to_numpy(), qsim))

    published = {"Hyst+Ice": 0.9133, "Hyst": 0.8765, "Ice": 0.8541}
    for name, (res, kge) in results.items():
        print(f"{name:9s}: fit fun={res.fun:.4f} nfev={res.nfev:6d} "
              f"KGE={kge:.4f}  (reference notebook: {published[name]})")


if __name__ == "__main__":
    main()
