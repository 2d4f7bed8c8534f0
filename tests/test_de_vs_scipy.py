"""Quality parity of the device-resident DE against scipy's.

The reference calibrates every model with scipy.optimize.
differential_evolution (e.g. rrmpg/models/gr4j.py:247).  Our DE follows
scipy's default configuration (best1bin, latin hypercube, dithered
mutation, binomial crossover, same convergence criterion) but runs fully
jitted on device; results are quality-comparable, not bit-identical
(different RNG streams).  This test pins "quality-comparable" on a real
GR4J parameter-recovery problem.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow


def test_de_matches_scipy_quality_on_gr4j_recovery():
    import jax.numpy as jnp
    from scipy.optimize import differential_evolution as scipy_de

    from rrmpg_jax.models import GR4J
    from rrmpg_jax.ops import run_gr4j
    from rrmpg_jax.tools.calibration import differential_evolution

    rng = np.random.default_rng(42)
    T = 730
    prec = rng.uniform(0, 12, T)
    etp = rng.uniform(0, 4, T)
    truth = {'x1': 350.0, 'x2': 1.2, 'x3': 110.0, 'x4': 2.1}
    qobs_j = run_gr4j(jnp.asarray(prec), jnp.asarray(etp), 0.3, 0.3,
                      truth)[0]
    qobs = np.asarray(qobs_j)

    bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]
    names = ['x1', 'x2', 'x3', 'x4']

    prec_j, etp_j = jnp.asarray(prec), jnp.asarray(etp)

    def jax_objective(x):
        p = dict(zip(names, x))
        qsim = run_gr4j(prec_j, etp_j, 0.3, 0.3, p)[0]
        return jnp.mean((qsim - qobs_j) ** 2)

    ours = differential_evolution(jax_objective, bounds, seed=0,
                                  maxiter=60, polish=True)

    # scipy on the same objective (jitted numpy wrapper), matched budget.
    # scipy's L-BFGS-B polish segfaults when re-entering jax from its
    # native finite-difference loop in this environment, so scipy runs
    # unpolished; the comparison threshold accounts for it.
    import jax
    jitted = jax.jit(jax_objective)

    def np_objective(x):
        return float(jitted(jnp.asarray(x)))

    sp = scipy_de(np_objective, bounds, seed=0, maxiter=60, tol=0.01,
                  polish=False)

    # Both should essentially recover the truth (MSE near zero) and land
    # within an order of magnitude of each other.
    assert ours.fun < 1e-2
    assert ours.fun < max(10 * sp.fun, 1e-2)
    # Parameter recovery within a few percent on the dominant stores.
    assert abs(ours.x[0] - truth['x1']) / truth['x1'] < 0.10
    assert abs(ours.x[2] - truth['x3']) / truth['x3'] < 0.10
