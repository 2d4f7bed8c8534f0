"""The ABC model's ``xla`` engines against each other and the C++ oracle.

The sequential scan (``run_abcmodel``), the parallel prefix
(``run_abcmodel_pscan``, ``lax.associative_scan``) and the hierarchical
Toeplitz matmul scan (``run_abcmodel_matscan``, ``ops/linear_scan.py``)
solve the same linear recurrence.  The lengths straddle the Toeplitz
chunk (127/128/129), its recursion levels (4,097, ~1e5) and the
degenerate single step; the coefficient cases cover a storage that never
drains (c=0) and one that empties every step (c=1).
"""

import numpy as np
import pytest

from rrmpg_jax import native
from rrmpg_jax.ops.abc import (run_abcmodel, run_abcmodel_matscan,
                               run_abcmodel_pscan)

from lane import tol

ENGINES = {'associative_scan': run_abcmodel_pscan,
           'matscan': run_abcmodel_matscan}
CASES = [(T, 0.12) for T in (1, 127, 128, 129, 4097, 100_003)] + [
    (20_000, 0.0), (20_000, 1.0)]


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("T,c", CASES)
def test_abc_engine_matches_scan_and_oracle(engine, T, c):
    prec = np.random.default_rng(T).uniform(0, 20, T)
    params = {'a': 0.3, 'b': 0.4, 'c': c}
    q_ref, s_ref = run_abcmodel(prec, 5.0, params)
    q, s = ENGINES[engine](prec, 5.0, params)
    assert q.shape == s.shape == (T,)
    np.testing.assert_allclose(np.asarray(q), np.asarray(q_ref),
                               rtol=tol(1e-9, 1e-4), atol=tol(1e-9, 1e-3))
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=tol(1e-9, 1e-4), atol=tol(1e-9, 1e-3))
    if native.available():
        q_c, s_c = native.oracle_abc(prec, 5.0, params)
        np.testing.assert_allclose(np.asarray(q), q_c, rtol=tol(1e-9, 1e-4),
                                   atol=tol(1e-9, 1e-3))
        np.testing.assert_allclose(np.asarray(s), s_c, rtol=tol(1e-9, 1e-4),
                                   atol=tol(1e-9, 1e-3))


def test_abcmodel_class_runs_xla_only():
    from rrmpg_jax.models import ABCModel

    model = ABCModel()
    prec = np.random.default_rng(5).uniform(0, 15, 3000)
    params = model.get_random_params(num=2)
    q, s = model.simulate(prec, initial_state=1.5, params=params,
                          return_storage=True)
    assert q.shape == s.shape == (3000, 2)
    for engine in ("pallas", "fortran"):
        with pytest.raises(ValueError):
            model.simulate(prec, params=params, engine=engine)
