"""Global sensitivity analysis: analytic validation + framework plumbing.

Sobol' estimators are validated on the Ishigami function, whose
variance decomposition is known in closed form; Morris screening on an
additive linear function (exact elementary effects) and on Ishigami's
interaction structure.  The reference has no sensitivity tooling
(beyond-reference capability; see COMPONENTS.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.tools.sensitivity import morris_screening, sobol_indices

from lane import tol

# Ishigami (a=7, b=0.1) on [-pi, pi]^3: the standard GSA test function.
A, B = 7.0, 0.1
_PI = np.pi
ISHIGAMI_BOUNDS = [(-_PI, _PI)] * 3


def ishigami(x):
    return (jnp.sin(x[0]) + A * jnp.sin(x[1]) ** 2
            + B * x[2] ** 4 * jnp.sin(x[0]))


def ishigami_batched(X):
    return jax.vmap(ishigami)(X)


def _ishigami_analytic():
    # Closed-form variance decomposition (e.g. Saltelli et al. 2010).
    v1 = 0.5 * (1 + B * _PI ** 4 / 5) ** 2
    v2 = A ** 2 / 8
    v13 = B ** 2 * _PI ** 8 * (1 / 18 - 1 / 50)
    v = v1 + v2 + v13
    s1 = np.array([v1 / v, v2 / v, 0.0])
    st = np.array([(v1 + v13) / v, v2 / v, v13 / v])
    return s1, st


class TestSobolIshigami:
    def test_matches_analytic(self):
        res = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=2048, seed=7)
        s1_true, st_true = _ishigami_analytic()
        np.testing.assert_allclose(res.s1, s1_true, atol=0.03)
        np.testing.assert_allclose(res.st, st_true, atol=0.03)
        assert res.n_used == res.n == 2048
        assert res.nfev == 2048 * 5

    def test_confidence_intervals_cover(self):
        res = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=2048, seed=3,
                            bootstrap=200)
        s1_true, st_true = _ishigami_analytic()
        # Generous 2x factor: 95% CIs on a QMC design are conservative.
        assert np.all(np.abs(res.s1 - s1_true) < 2 * res.s1_conf + 0.02)
        assert np.all(np.abs(res.st - st_true) < 2 * res.st_conf + 0.02)
        assert np.all(res.s1_conf > 0)

    def test_batched_equals_vmapped(self):
        r1 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=256, seed=5,
                           bootstrap=0)
        r2 = sobol_indices(ishigami_batched, ISHIGAMI_BOUNDS, n=256,
                           seed=5, batched=True, bootstrap=0)
        np.testing.assert_allclose(r1.s1, r2.s1, rtol=1e-10)
        np.testing.assert_allclose(r1.st, r2.st, rtol=1e-10)

    def test_batch_size_chunking_identical(self):
        r1 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=256, seed=5,
                           bootstrap=0)
        r2 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=256, seed=5,
                           bootstrap=0, batch_size=100)  # ragged chunks
        np.testing.assert_allclose(r1.s1, r2.s1, rtol=1e-12)
        np.testing.assert_allclose(r1.st, r2.st, rtol=1e-12)

    def test_mesh_sharded_equals_unsharded(self):
        from rrmpg_jax.parallel.mesh import default_mesh

        mesh = default_mesh()
        r1 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=256, seed=5,
                           bootstrap=0)
        r2 = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=256, seed=5,
                           bootstrap=0, mesh=mesh)
        np.testing.assert_allclose(r1.s1, r2.s1, rtol=1e-10)
        np.testing.assert_allclose(r1.st, r2.st, rtol=1e-10)

    def test_nonfinite_rows_dropped(self):
        def guarded(x):
            val = ishigami(x)
            return jnp.where(x[0] > 2.0, jnp.nan, val)

        res = sobol_indices(guarded, ISHIGAMI_BOUNDS, n=512, seed=11,
                            bootstrap=0)
        assert 0 < res.n_used < 512
        assert np.all(np.isfinite(res.s1))
        assert np.all(np.isfinite(res.st))

    def test_all_nonfinite_raises(self):
        with pytest.raises(ValueError, match="finite"):
            sobol_indices(lambda x: jnp.nan * x[0], ISHIGAMI_BOUNDS,
                          n=64, seed=0, bootstrap=0)

    def test_names_and_mismatch(self):
        res = sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=64, seed=0,
                            bootstrap=0, names=('x1', 'x2', 'x3'))
        assert res.names == ('x1', 'x2', 'x3')
        with pytest.raises(ValueError, match="names"):
            sobol_indices(ishigami, ISHIGAMI_BOUNDS, n=64, names=('a',))


class TestMorris:
    def test_linear_function_exact(self):
        # f = 3 z0 - 5 z1 + 0 z2 in normalized coordinates: elementary
        # effects are exactly the coefficients, sigma = 0.
        coefs = np.array([3.0, -5.0, 0.0])
        bounds = [(0.0, 1.0)] * 3

        def f(x):
            return coefs[0] * x[0] + coefs[1] * x[1] + coefs[2] * x[2]

        res = morris_screening(f, bounds, num_trajectories=16, seed=1,
                               bootstrap=0)
        np.testing.assert_allclose(res.mu, coefs, atol=tol(1e-10, 1e-4))
        np.testing.assert_allclose(res.mu_star, np.abs(coefs),
                                   atol=tol(1e-10, 1e-4))
        np.testing.assert_allclose(res.sigma, 0.0, atol=tol(1e-10, 1e-4))
        assert res.nfev == 16 * 4
        np.testing.assert_array_equal(res.n_effects, 16)

    def test_unit_scaling_of_physical_bounds(self):
        # Same normalized function on stretched physical bounds: the
        # normalized-coordinate elementary effects must not change.
        def f(x):
            return 2.0 * (x[0] / 1000.0) - (x[1] + 5.0) / 8.0

        res = morris_screening(f, [(0, 1000), (-5, 3)],
                               num_trajectories=8, seed=2, bootstrap=0)
        np.testing.assert_allclose(res.mu, [2.0, -1.0], atol=1e-10)

    def test_ishigami_ranking_and_interaction(self):
        res = morris_screening(ishigami, ISHIGAMI_BOUNDS,
                               num_trajectories=256, seed=4)
        # x1 (main + interaction with x2 in the Sobol sense here: sin^2)
        # and x0 dominate; x2 acts only through the interaction term, so
        # its sigma must be comparable to its mu_star (nonlinearity).
        assert res.mu_star[1] > res.mu_star[2]
        assert res.sigma[2] > 0.5 * res.mu_star[2]
        # x2 enters only multiplicatively with sin(x0): mean effect about
        # zero by symmetry, so |mu| << mu_star flags non-monotonicity.
        assert abs(res.mu[2]) < 0.5 * res.mu_star[2]
        assert np.all(res.mu_star_conf > 0)

    def test_trajectory_points_in_bounds(self):
        from rrmpg_jax.tools.sensitivity import _morris_trajectories

        rng = np.random.default_rng(0)
        for p in (2, 4, 8):
            trajs, delta = _morris_trajectories(rng, 64, 5, p)
            assert trajs.min() >= 0.0 and trajs.max() <= 1.0
            # Consecutive points differ in exactly one coordinate by
            # exactly +-delta.
            d = trajs[:, 1:] - trajs[:, :-1]
            nz = np.abs(d) > 1e-12
            np.testing.assert_array_equal(nz.sum(axis=2), 1)
            np.testing.assert_allclose(np.abs(d[nz]), delta)

    def test_odd_levels_rejected(self):
        with pytest.raises(ValueError, match="even"):
            morris_screening(ishigami, ISHIGAMI_BOUNDS, num_levels=3)

    def test_nonfinite_effects_dropped(self):
        def guarded(x):
            # NaN only at the top grid level of x0: poisons the x1
            # effects computed there and the x0 effects reaching it,
            # but both parameters keep effects elsewhere.
            return jnp.where(x[0] > 0.9, jnp.nan, x[1] + 0.1 * x[0])

        res = morris_screening(guarded, [(-1, 1), (0, 1)],
                               num_trajectories=64, seed=9, bootstrap=0)
        assert res.n_effects[0] < 64
        assert res.n_effects[1] < 64
        assert (res.n_effects > 0).all()
        assert np.isfinite(res.mu_star).all()
        # The surviving effects are still exact for this linear function.
        np.testing.assert_allclose(res.mu_star[1], 1.0, atol=1e-10)

    def test_all_nonfinite_raises(self):
        with pytest.raises(ValueError, match="elementary effects"):
            morris_screening(lambda x: jnp.nan * x[0], [(0, 1), (0, 1)],
                             num_trajectories=8, seed=0, bootstrap=0)

    def test_bootstrap_conf_finite_with_few_effects(self):
        # Regression: the joint trajectory resample could draw zero
        # finite effects for a parameter and emit NaN intervals even
        # when the point estimates are fine.
        def guarded(x):
            return jnp.where(x[0] > 2.0, jnp.nan, x[0] + x[1])

        res = morris_screening(guarded, [(-np.pi, np.pi)] * 2,
                               num_trajectories=4, seed=3,
                               bootstrap=400)
        assert np.isfinite(res.mu_star_conf).all()
        assert np.isfinite(res.mu_star).all()


class TestHydrologyModel:
    @pytest.mark.slow
    def test_batched_fused_pallas_objective(self):
        """The advertised fused-kernel path: a (P, dim) -> (P,) Pallas
        MSE objective plugs into both GSA entry points via batched=True
        (interpret mode on CPU) and matches the vmapped XLA objective."""
        from rrmpg_jax.ops.gr4j import run_gr4j
        from rrmpg_jax.ops.pallas_gr4j import gr4j_ensemble_mse_pallas
        from rrmpg_jax.utils.metrics import mse

        rng = np.random.default_rng(0)
        T = 128
        prec = jnp.asarray(rng.uniform(0, 15, T))
        etp = jnp.asarray(rng.uniform(0, 4, T))
        qobs = jnp.asarray(rng.uniform(0, 5, T))
        bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]

        def fused(X):
            params = {'x1': X[:, 0], 'x2': X[:, 1], 'x3': X[:, 2],
                      'x4': X[:, 3]}
            return gr4j_ensemble_mse_pallas(prec, etp, qobs, 0.0, 0.0,
                                            params, num_uh1=3, num_uh2=7,
                                            interpret=True)

        def xla(x):
            params = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
            qsim, _, _ = run_gr4j(prec, etp, 0.0, 0.0, params,
                                  num_uh1=3, num_uh2=7)
            return mse(qobs, qsim)

        r_fused = sobol_indices(fused, bounds, n=64, seed=1,
                                batched=True, bootstrap=0)
        r_xla = sobol_indices(xla, bounds, n=64, seed=1, bootstrap=0)
        np.testing.assert_allclose(r_fused.s1, r_xla.s1,
                                   atol=tol(1e-5, 5e-3))
        np.testing.assert_allclose(r_fused.st, r_xla.st,
                                   atol=tol(1e-5, 5e-3))

        m_fused = morris_screening(fused, bounds, num_trajectories=8,
                                   seed=1, batched=True, bootstrap=0)
        m_xla = morris_screening(xla, bounds, num_trajectories=8,
                                 seed=1, bootstrap=0)
        np.testing.assert_allclose(m_fused.mu_star, m_xla.mu_star,
                                   rtol=tol(1e-5, 3e-3))

    def test_morris_mesh_sharded_equals_unsharded(self):
        from rrmpg_jax.parallel.mesh import default_mesh

        r1 = morris_screening(ishigami, ISHIGAMI_BOUNDS,
                              num_trajectories=16, seed=5, bootstrap=0)
        r2 = morris_screening(ishigami, ISHIGAMI_BOUNDS,
                              num_trajectories=16, seed=5, bootstrap=0,
                              mesh=default_mesh())
        np.testing.assert_allclose(r1.mu_star, r2.mu_star, rtol=1e-10)
        np.testing.assert_allclose(r1.sigma, r2.sigma, rtol=1e-10)

    def test_gr4j_mse_sensitivity(self):
        """End-to-end: which GR4J parameters does the MSE respond to?"""
        from rrmpg_jax.models import GR4J
        from rrmpg_jax.ops.gr4j import run_gr4j
        from rrmpg_jax.utils.metrics import mse

        rng = np.random.default_rng(0)
        T = 365
        prec = jnp.asarray(rng.uniform(0, 15, T))
        etp = jnp.asarray(rng.uniform(0, 4, T))
        model = GR4J(params={'x1': 400.0, 'x2': 1.0, 'x3': 100.0,
                             'x4': 1.5})
        qobs = jnp.asarray(model.simulate(prec, etp)[:, 0])

        def objective(x):
            params = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
            qsim, _, _ = run_gr4j(prec, etp, 0.0, 0.0, params)
            return mse(qobs, qsim)

        bounds = [model._default_bounds[p] for p in model._param_list]
        res = morris_screening(objective, bounds, num_trajectories=24,
                               seed=0, bootstrap=0,
                               names=tuple(model._param_list))
        assert res.names == ('x1', 'x2', 'x3', 'x4')
        # Every GR4J parameter influences MSE somewhere in the space.
        assert np.all(res.mu_star > 0)
        # The groundwater-exchange x2 directly shifts the water balance
        # and dominates the MSE response for a synthetic truth; x4 (UH
        # time base) only reshapes the hydrograph.
        assert res.mu_star[1] > res.mu_star[3]
