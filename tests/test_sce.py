"""SCE-UA optimizer: convergence, accounting, quarantine, sharding.

The device-resident shuffled-complex-evolution calibrator
(rrmpg_jax/tools/sce.py) is validated on standard optimization test
functions, checked for exact nfev accounting and determinism, and its
class-level dispatch (``model.fit(method='sce')``) is exercised on a
synthetic-truth calibration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.tools.calibration import minimize
from rrmpg_jax.tools.sce import sce_ua

from lane import tol


def rosen(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def ackley(x):
    a, b, c = 20.0, 0.2, 2.0 * jnp.pi
    return (-a * jnp.exp(-b * jnp.sqrt(jnp.mean(x ** 2)))
            - jnp.exp(jnp.mean(jnp.cos(c * x))) + a + jnp.e)


BOUNDS2 = [(-5.0, 10.0), (-5.0, 10.0)]


class TestSceUa:
    def test_rosenbrock_converges(self):
        res = sce_ua(rosen, BOUNDS2, seed=0, maxiter=200, tol=0.0,
                     peps=1e-7)
        # The geometric-collapse stopping flag is a race against SCE's
        # perpetual mutation injection (the worst simplex member is
        # re-randomized whenever reflection/contraction fail), so whether
        # it trips within maxiter is seed- and precision-dependent; under
        # float32 seed 0 happens to lose that race while the optimum
        # itself (asserted below) is found to 6e-12.  Flag semantics are
        # pinned in the f64 lane only.
        from lane import IS_F32
        if not IS_F32:
            assert res.success
        np.testing.assert_allclose(res.x, [1.0, 1.0],
                                   atol=tol(1e-4, 1e-3))
        assert res.fun < 1e-8

    def test_multimodal_global_minimum(self):
        # Ackley has ~an exponential number of local minima; SCE-UA's
        # shuffled complexes must reach the global basin at the origin.
        res = sce_ua(ackley, [(-32.8, 32.8)] * 2, seed=1, maxiter=150,
                     n_complexes=8)
        np.testing.assert_allclose(res.x, [0.0, 0.0], atol=1e-3)
        assert res.fun < 1e-2

    def test_nfev_accounting_exact(self):
        res = sce_ua(rosen, BOUNDS2, seed=0, maxiter=7, tol=0.0,
                     peps=0.0)
        dim = 2
        p, m, beta = max(2, dim), 2 * dim + 1, 2 * dim + 1
        assert res.nit == 7
        assert res.nfev == p * m + res.nit * beta * 3 * p
        assert not res.success

    def test_deterministic_under_seed(self):
        r1 = sce_ua(rosen, BOUNDS2, seed=42, maxiter=20)
        r2 = sce_ua(rosen, BOUNDS2, seed=42, maxiter=20)
        np.testing.assert_array_equal(r1.x, r2.x)
        np.testing.assert_array_equal(r1.population, r2.population)
        assert r1.fun == r2.fun

    def test_population_within_bounds(self):
        res = sce_ua(rosen, BOUNDS2, seed=3, maxiter=30)
        lo = np.array([b[0] for b in BOUNDS2])
        hi = np.array([b[1] for b in BOUNDS2])
        assert (res.population >= lo - 1e-12).all()
        assert (res.population <= hi + 1e-12).all()

    def test_batched_objective(self):
        def rosen_batch(X):
            return ((1.0 - X[:, 0]) ** 2
                    + 100.0 * (X[:, 1] - X[:, 0] ** 2) ** 2)

        res = sce_ua(rosen_batch, BOUNDS2, seed=0, maxiter=200,
                     batched=True, tol=0.0, peps=1e-7)
        np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-4)
        # Same RNG stream as the vmapped path => identical evolution.
        ref = sce_ua(rosen, BOUNDS2, seed=0, maxiter=200, tol=0.0,
                     peps=1e-7)
        np.testing.assert_array_equal(res.x, ref.x)

    def test_nonfinite_quarantine(self):
        # NaN plateau covering most of the space: the best member must
        # still be finite and near the true minimum at (1, 1).
        def guarded(x):
            return jnp.where((x[0] < 0.0) | (x[1] < 0.0), jnp.nan,
                             rosen(x))

        res = sce_ua(guarded, BOUNDS2, seed=5, maxiter=100)
        assert np.isfinite(res.fun)
        np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-2)

    def test_mesh_sharded_identical(self):
        from rrmpg_jax.parallel.mesh import default_mesh

        mesh = default_mesh()
        ref = sce_ua(rosen, BOUNDS2, seed=0, maxiter=25, n_complexes=8)
        res = sce_ua(rosen, BOUNDS2, seed=0, maxiter=25, n_complexes=8,
                     mesh=mesh)
        # Sharding must not change the arithmetic: same RNG stream, same
        # evolution (complex axis 8 over 8 devices).
        np.testing.assert_allclose(res.population, ref.population,
                                   rtol=1e-12)
        assert res.fun == pytest.approx(ref.fun, rel=1e-12)

    def test_mesh_batched_rejected(self):
        from rrmpg_jax.parallel.mesh import default_mesh

        with pytest.raises(ValueError, match="vmappable"):
            sce_ua(lambda X: X[:, 0], BOUNDS2, batched=True,
                   mesh=default_mesh())

    def test_minimize_dispatch(self):
        res = minimize(rosen, BOUNDS2, method="sce", seed=0, maxiter=50)
        assert res.fun < 1e-3
        res_de = minimize(rosen, BOUNDS2, method="de", seed=0,
                          maxiter=50)
        assert res_de.fun < 1e-3
        with pytest.raises(ValueError, match="method"):
            minimize(rosen, BOUNDS2, method="nelder-mead")


class TestClassLevelSce:
    @pytest.mark.slow
    def test_sce_with_fused_pallas_objective(self):
        """SCE-UA drives the fused Pallas MSE kernel via batched=True
        (interpret mode on CPU) and reaches the same optimum region as
        the vmapped XLA objective."""
        from rrmpg_jax.models import GR4J
        from rrmpg_jax.ops.pallas_gr4j import gr4j_ensemble_mse_pallas

        rng = np.random.default_rng(0)
        T = 128
        prec = rng.uniform(0, 15, T)
        etp = rng.uniform(0, 4, T)
        truth = {'x1': 350.0, 'x2': 1.2, 'x3': 80.0, 'x4': 1.8}
        qobs = GR4J(params=truth).simulate(prec, etp)[:, 0]
        prec_j, etp_j, qobs_j = (jnp.asarray(a) for a in
                                 (prec, etp, qobs))

        def fused(X):
            params = {'x1': X[:, 0], 'x2': X[:, 1], 'x3': X[:, 2],
                      'x4': X[:, 3]}
            return gr4j_ensemble_mse_pallas(prec_j, etp_j, qobs_j, 0.0,
                                            0.0, params, num_uh1=3,
                                            num_uh2=7, interpret=True)

        bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]
        res = sce_ua(fused, bounds, seed=0, maxiter=30, batched=True,
                     n_complexes=4)
        assert np.isfinite(res.fun)
        assert res.fun < 0.5

    def test_gr4j_fit_method_sce(self):
        """model.fit(method='sce') recovers a synthetic truth."""
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(0)
        T = 365
        prec = rng.uniform(0, 15, T)
        etp = rng.uniform(0, 4, T)
        truth = {'x1': 350.0, 'x2': 1.2, 'x3': 80.0, 'x4': 1.8}
        qobs = GR4J(params=truth).simulate(prec, etp)[:, 0]

        res = GR4J().fit(qobs, prec, etp, seed=0, method='sce',
                         maxiter=60, n_complexes=6)
        assert res.fun < 1e-2
