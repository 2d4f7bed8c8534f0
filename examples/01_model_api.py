"""End-to-end model API walkthrough on the bundled CAMELS basin.

Mirrors the reference's model_api_example notebook
(``docs/source/examples/model_api_example.rst``): load data, split into
calibration/validation periods, calibrate CemaneigeGR4J two ways
(Monte-Carlo and differential evolution), and compare NSE on validation.
"""

import os

import numpy as np

from rrmpg_jax.data import CAMELSLoader
from rrmpg_jax.models import CemaneigeGR4J
from rrmpg_jax.tools import monte_carlo
from rrmpg_jax.utils import calc_nse

# CI fast mode (tests/test_examples.py): tiny sizes so the example
# executes end-to-end in seconds; the didactic sizes are the defaults.
FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def forcings(df, height):
    return dict(prec=df['prcp(mm/day)'], mean_temp=(df['tmax(C)'] +
                                                    df['tmin(C)']) / 2,
                min_temp=df['tmin(C)'], max_temp=df['tmax(C)'],
                etp=df['PET'], met_station_height=height)


def main():
    loader = CAMELSLoader()
    df = loader.load_basin('01031500')
    height = loader.get_station_height('01031500')

    # First 15 hydrological years calibrate, the rest validate (exact
    # Sep-30 / Oct-1 split as in the reference notebook).
    end_cal = f"{df.index[0].year + 15}-09-30"
    start_val = f"{df.index[0].year + 15}-10-01"
    cal, val = df[:end_cal], df[start_val:]

    model = CemaneigeGR4J()

    # --- Monte Carlo: 10k random parameter sets, one device program ---
    mc = monte_carlo(model, num=500 if FAST else 10_000,
                     qobs=cal['QObs(mm/d)'].to_numpy(),
                     **forcings(cal, height))
    best = np.argmin(mc['mse'])
    model.set_params(mc['params'][best])
    qsim_val = model.simulate(**forcings(val, height))
    nse_mc = calc_nse(val['QObs(mm/d)'].to_numpy(), qsim_val[:, 0])
    print(f"Monte-Carlo best-of-10k:  cal MSE {mc['mse'][best]:.3f}  "
          f"val NSE {nse_mc:.4f}")

    # --- Differential evolution (device-resident), with the gradient
    # polish step that scipy's L-BFGS-B polish corresponds to ---
    res = model.fit(cal['QObs(mm/d)'].to_numpy(), seed=0, polish=True,
                    maxiter=5 if FAST else 1000, **forcings(cal, height))
    model.set_params({p: v for p, v in zip(model.get_parameter_names(),
                                           res.x)})
    qsim_val = model.simulate(**forcings(val, height))
    nse_de = calc_nse(val['QObs(mm/d)'].to_numpy(), qsim_val[:, 0])
    print(f"DE calibration:           cal MSE {res.fun:.3f}  "
          f"(nfev {res.nfev})  val NSE {nse_de:.4f}")


if __name__ == "__main__":
    main()
