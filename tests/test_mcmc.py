"""DE-MC posterior sampler: analytic targets + hydrological inference.

The sampler is validated against targets with known posteriors
(correlated Gaussian moments, mixture mass balance, uniform-box
coverage) and a GR4J synthetic-truth inference where the posterior
must concentrate around the generating parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.tools.mcmc import demc_sample


class TestGaussianTarget:
    def test_recovers_correlated_gaussian(self):
        mean = jnp.asarray([1.0, -0.5])
        cov = np.array([[1.0, 0.8], [0.8, 1.0]])
        prec = jnp.asarray(np.linalg.inv(cov))

        def lp(x):
            d = x - mean
            return -0.5 * d @ prec @ d

        res = demc_sample(lp, [(-10, 10), (-10, 10)], num_chains=16,
                          num_steps=4000, seed=0)
        flat = res.flat()
        np.testing.assert_allclose(flat.mean(0), [1.0, -0.5], atol=0.1)
        np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.15)
        assert 0.15 < res.acceptance_rate < 0.6
        assert (res.r_hat < 1.05).all()
        # MAP draw lies near the mode.
        np.testing.assert_allclose(res.x_map, [1.0, -0.5], atol=0.3)

    def test_deterministic_and_batched(self):
        def lp(x):
            return -0.5 * jnp.sum(x ** 2)

        r1 = demc_sample(lp, [(-5, 5)] * 3, num_steps=200, seed=7)
        r2 = demc_sample(lp, [(-5, 5)] * 3, num_steps=200, seed=7)
        np.testing.assert_array_equal(r1.samples, r2.samples)

        def lp_batched(X):
            return -0.5 * jnp.sum(X ** 2, axis=1)

        r3 = demc_sample(lp_batched, [(-5, 5)] * 3, num_steps=200,
                         seed=7, batched=True)
        np.testing.assert_allclose(r3.samples, r1.samples, rtol=1e-12)

    def test_bounds_are_prior_support(self):
        # Flat target on a box: all draws inside, coverage roughly
        # uniform.
        def lp(x):
            return jnp.asarray(0.0)

        res = demc_sample(lp, [(2.0, 3.0), (-1.0, 0.0)], num_chains=16,
                          num_steps=2000, seed=1)
        flat = res.flat()
        assert flat[:, 0].min() >= 2.0 and flat[:, 0].max() <= 3.0
        assert flat[:, 1].min() >= -1.0 and flat[:, 1].max() <= 0.0
        np.testing.assert_allclose(flat.mean(0), [2.5, -0.5], atol=0.08)

    def test_bimodal_mode_jumping(self):
        # Two well-separated modes; the gamma=1 jumps plus LHS chain
        # init must leave substantial mass on both.
        def lp(x):
            return jnp.logaddexp(-0.5 * ((x[0] + 3) / 0.4) ** 2,
                                 -0.5 * ((x[0] - 3) / 0.4) ** 2)

        res = demc_sample(lp, [(-8.0, 8.0)], num_chains=24,
                          num_steps=3000, seed=2)
        flat = res.flat()[:, 0]
        frac_left = float((flat < 0).mean())
        assert 0.2 < frac_left < 0.8

    def test_nonfinite_logprob_rejected(self):
        def lp(x):
            return jnp.where(x[0] > 0.5, jnp.nan, -0.5 * x[0] ** 2)

        res = demc_sample(lp, [(-2.0, 2.0)], num_chains=8,
                          num_steps=500, seed=3)
        assert np.isfinite(res.log_probs).all()
        assert (res.flat()[:, 0] <= 0.5).all()

    def test_validation(self):
        lp = lambda x: -jnp.sum(x ** 2)  # noqa: E731
        with pytest.raises(ValueError, match="burn_in"):
            demc_sample(lp, [(0, 1)], burn_in=1.0)
        with pytest.raises(ValueError, match="thin"):
            demc_sample(lp, [(0, 1)], thin=0)
        with pytest.raises(ValueError, match="chains"):
            demc_sample(lp, [(0, 1)], num_chains=2)
        # An odd request rounds up to equal half-ensembles.
        res = demc_sample(lambda x: -jnp.sum(x ** 2), [(0, 1)],
                          num_chains=5, num_steps=20, seed=0)
        assert res.samples.shape[1] == 6

    def test_mesh_sharded_identical(self):
        from rrmpg_jax.parallel.mesh import default_mesh

        def lp(x):
            return -0.5 * jnp.sum(x ** 2)

        ref = demc_sample(lp, [(-5, 5)] * 2, num_chains=16,
                          num_steps=300, seed=4)
        res = demc_sample(lp, [(-5, 5)] * 2, num_chains=16,
                          num_steps=300, seed=4, mesh=default_mesh())
        np.testing.assert_allclose(res.samples, ref.samples, rtol=1e-12)
        assert res.acceptance_rate == pytest.approx(ref.acceptance_rate)

    def test_mesh_batched_rejected(self):
        from rrmpg_jax.parallel.mesh import default_mesh

        with pytest.raises(ValueError, match="vmappable"):
            demc_sample(lambda X: -jnp.sum(X ** 2, axis=1), [(0, 1)] * 2,
                        batched=True, mesh=default_mesh())

    def test_thinning_and_burn_in_shapes(self):
        def lp(x):
            return -0.5 * jnp.sum(x ** 2)

        res = demc_sample(lp, [(-5, 5)] * 2, num_chains=8,
                          num_steps=1000, burn_in=0.4, thin=5, seed=0)
        assert res.samples.shape == (120, 8, 2)
        assert res.log_probs.shape == (120, 8)


class TestHydrologyPosterior:
    @pytest.mark.slow
    def test_gr4j_posterior_concentrates_on_truth(self):
        """Gaussian likelihood around a synthetic truth: the pooled
        posterior mean must sit near the generating parameters and the
        truth must lie inside the central 95% credible box."""
        from rrmpg_jax.models import GR4J
        from rrmpg_jax.ops.gr4j import run_gr4j

        rng = np.random.default_rng(0)
        T = 365
        prec = jnp.asarray(rng.gamma(0.8, 6.0, T))
        etp = jnp.asarray(rng.uniform(1, 4, T))
        truth = np.array([350.0, 1.2, 80.0, 1.8])
        q_true, _, _ = run_gr4j(prec, etp, 0.0, 0.0,
                                {'x1': truth[0], 'x2': truth[1],
                                 'x3': truth[2], 'x4': truth[3]})
        sigma = 0.05
        qobs = jnp.asarray(np.asarray(q_true)
                           + rng.normal(0, sigma, T))

        def log_prob(x):
            qsim, _, _ = run_gr4j(prec, etp, 0.0, 0.0,
                                  {'x1': x[0], 'x2': x[1], 'x3': x[2],
                                   'x4': x[3]})
            return -0.5 * jnp.sum(((qobs - qsim) / sigma) ** 2)

        bounds = [GR4J._default_bounds[p] for p in GR4J._param_list]
        res = demc_sample(log_prob, bounds, num_chains=16,
                          num_steps=3000, seed=0)
        flat = res.flat()
        lo, hi = np.percentile(flat, [2.5, 97.5], axis=0)
        assert ((truth >= lo) & (truth <= hi)).all()
        # x2 (the most identifiable parameter here) pins tightly.
        assert abs(flat[:, 1].mean() - truth[1]) < 0.2
        # MAP reproduces the truth hydrograph closely.
        np.testing.assert_allclose(res.x_map[1], truth[1], atol=0.2)
