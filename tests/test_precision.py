"""Quantify float32 drift against the float64 reference trajectories.

Validation runs in float64 (exact parity with the reference's golden
data); large ensembles on the card run in float32.  These tests bound the drift so
the f32 production mode is a known quantity: discharge stays within a
small relative envelope of the f64 trajectory over multi-year series.
"""

import jax
import numpy as np
import pytest

from rrmpg_jax.ops import run_cemaneigegr4j, run_gr4j


def _rel_err(a, b):
    scale = np.maximum(np.abs(b), 1e-2)
    return np.max(np.abs(a - b) / scale)


def test_gr4j_f32_drift_bounded():
    rng = np.random.default_rng(0)
    T = 3651
    prec64 = rng.uniform(0, 15, T)
    etp64 = rng.uniform(0, 4, T)
    params64 = {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}

    q64, s64, r64 = run_gr4j(prec64, etp64, 0.4, 0.3, params64)

    prec32 = prec64.astype(np.float32)
    etp32 = etp64.astype(np.float32)
    params32 = {k: np.float32(v) for k, v in params64.items()}
    q32, s32, r32 = run_gr4j(prec32, etp32, 0.4, 0.3, params32)

    assert np.asarray(q32).dtype == np.float32
    # Dissipative stores: drift stays small relative to the flow scale.
    assert _rel_err(np.asarray(q32, np.float64), np.asarray(q64)) < 5e-3
    assert _rel_err(np.asarray(s32, np.float64), np.asarray(s64)) < 1e-3


def test_cemaneigegr4j_f32_objective_drift():
    rng = np.random.default_rng(1)
    T, L = 1827, 5
    prec = rng.uniform(0, 15, (T, L))
    temp = rng.uniform(-12, 18, (T, L))
    frac = np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1)
    etp = rng.uniform(0, 4, T)
    qobs = rng.uniform(0, 5, T)
    params = {'CTG': 0.25, 'Kf': 3.74, 'x1': 191.3, 'x2': 2.4,
              'x3': 80.3, 'x4': 3.1}

    def mse(dtype):
        cast = lambda a: np.asarray(a, dtype)
        q, *_ = run_cemaneigegr4j(cast(prec), cast(temp), cast(etp),
                                  cast(frac), 0.0, 0.0, 0.6, 0.7,
                                  {k: dtype(v) for k, v in params.items()})
        return float(np.mean((np.asarray(q, np.float64) - qobs) ** 2))

    m64 = mse(np.float64)
    m32 = mse(np.float32)
    # Objective values agree to ~0.1% -- calibration decisions are stable
    # under f32.
    assert abs(m32 - m64) / m64 < 1e-3
