"""Ensemble Kalman filter: analytic correctness + hydrological twin test.

The stochastic EnKF update is checked against the exact Kalman-filter
posterior on a linear-Gaussian problem (where both are available in
closed form), and the full forecast/analysis cycle is validated with a
GR4J twin experiment: assimilating discharge must pull a biased
ensemble toward the truth states relative to the free-running ensemble.
"""

import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.tools.assimilation import (
    CONSTANT_FIELDS,
    assimilation_cycle,
    enkf_update,
    particle_filter_update,
    perturb_state,
)

from lane import tol


class ToyState(typing.NamedTuple):
    a: jnp.ndarray        # (N,)
    b: jnp.ndarray        # (N, 2)
    g_thresh: jnp.ndarray  # (N,) series constant: must stay frozen


def _gaussian_ensemble(key, n, mean, cov):
    L = np.linalg.cholesky(cov)
    z = jax.random.normal(key, (n, len(mean)))
    return np.asarray(mean) + np.asarray(z) @ L.T


class TestEnKFLinearGaussian:
    def test_matches_kalman_posterior(self):
        """Large-N EnKF == exact Kalman update (mean and covariance)."""
        rng_key = jax.random.PRNGKey(0)
        n = 40000
        mean0 = np.array([1.0, -2.0, 0.5])
        cov0 = np.array([[1.0, 0.3, 0.0],
                         [0.3, 2.0, 0.4],
                         [0.0, 0.4, 0.5]])
        H = np.array([[1.0, 0.0, 1.0]])          # observe a + b2
        obs = np.array([3.0])
        r = 0.25                                  # obs variance (std 0.5)

        k1, k2 = jax.random.split(rng_key)
        X = _gaussian_ensemble(k1, n, mean0, cov0)
        state = ToyState(a=jnp.asarray(X[:, 0]),
                         b=jnp.asarray(X[:, 1:3]),
                         g_thresh=jnp.full((n,), 7.7))
        predicted = X @ H.T                       # (N, 1) exact linear h

        new = enkf_update(state, predicted, obs, 0.5, k2)
        Xa = np.column_stack([np.asarray(new.a), np.asarray(new.b)])

        # Exact Kalman posterior.
        S = H @ cov0 @ H.T + r
        K = cov0 @ H.T / S
        mean_post = mean0 + (K @ (obs - H @ mean0)).ravel()
        cov_post = cov0 - K @ H @ cov0

        np.testing.assert_allclose(Xa.mean(axis=0), mean_post,
                                   atol=tol(0.02, 0.05))
        np.testing.assert_allclose(np.cov(Xa.T), cov_post, atol=0.04)

    def test_constant_fields_frozen(self):
        key = jax.random.PRNGKey(1)
        n = 128
        state = ToyState(a=jnp.arange(n, dtype=jnp.float64),
                         b=jnp.ones((n, 2)),
                         g_thresh=jnp.full((n,), 3.0))
        predicted = np.asarray(state.a)
        new = enkf_update(state, predicted, 5.0, 1.0, key)
        np.testing.assert_array_equal(np.asarray(new.g_thresh),
                                      np.asarray(state.g_thresh))
        assert not np.allclose(np.asarray(new.a), np.asarray(state.a))

    def test_custom_frozen_and_all_frozen_error(self):
        key = jax.random.PRNGKey(2)
        n = 16
        state = ToyState(a=jnp.ones(n), b=jnp.ones((n, 2)),
                         g_thresh=jnp.ones(n))
        new = enkf_update(state, np.ones(n) * 2, 1.0, 1.0, key,
                          frozen=CONSTANT_FIELDS | {"b"})
        np.testing.assert_array_equal(np.asarray(new.b),
                                      np.asarray(state.b))
        with pytest.raises(ValueError, match="frozen"):
            enkf_update(state, np.ones(n), 1.0, 1.0, key,
                        frozen={"a", "b", "g_thresh"})

    def test_single_member_rejected(self):
        state = ToyState(a=jnp.ones(1), b=jnp.ones((1, 2)),
                         g_thresh=jnp.ones(1))
        with pytest.raises(ValueError, match="N >= 2"):
            enkf_update(state, np.ones(1), 1.0, 1.0,
                        jax.random.PRNGKey(0))

    def test_predicted_shape_mismatch(self):
        state = ToyState(a=jnp.ones(8), b=jnp.ones((8, 2)),
                         g_thresh=jnp.ones(8))
        with pytest.raises(ValueError, match="predicted"):
            enkf_update(state, np.ones((8, 3)), np.array([1.0, 2.0]),
                        1.0, jax.random.PRNGKey(0))

    def test_inflation_widens_prior(self):
        key = jax.random.PRNGKey(3)
        n = 4096
        state = ToyState(a=jnp.asarray(np.random.default_rng(0)
                                       .normal(0, 1, n)),
                         b=jnp.zeros((n, 2)), g_thresh=jnp.zeros(n))
        pred = np.full(n, 1000.0)  # uninformative obs direction: zero
        pred = pred + np.random.default_rng(1).normal(0, 1e-6, n)
        # With a huge obs error the update is ~identity, exposing the
        # inflated anomalies directly.
        new = enkf_update(state, pred, 1000.0, 1e6, key, inflation=1.5)
        ratio = float(np.std(np.asarray(new.a))
                      / np.std(np.asarray(state.a)))
        assert ratio == pytest.approx(1.5, rel=1e-3)

    def test_inflation_consistent_with_kalman(self):
        """Inflation must scale state AND predicted-obs anomalies: the
        posterior must match the exact Kalman update of the *inflated*
        prior (an Xa-only inflation makes the gain grow linearly and
        overshoot the observation)."""
        n = 200_000
        infl = 2.0
        key = jax.random.PRNGKey(0)
        k1, k2 = jax.random.split(key)
        x = 1.0 + np.asarray(jax.random.normal(k1, (n,)))  # N(1, 1)
        state = ToyState(a=jnp.asarray(x), b=jnp.zeros((n, 2)),
                         g_thresh=jnp.zeros(n))
        new = enkf_update(state, x, 3.0, 0.5, k2, inflation=infl)
        a = np.asarray(new.a)

        p_infl = np.var(x) * infl ** 2
        gain = p_infl / (p_infl + 0.25)
        mean_post = np.mean(x) + gain * (3.0 - np.mean(x))
        var_post = (1 - gain) * p_infl
        assert a.mean() == pytest.approx(mean_post, abs=0.02)
        assert a.var() == pytest.approx(var_post, abs=0.02)
        # In particular: never past the observation.
        assert a.mean() < 3.0

    def test_frozen_matches_exact_leaf_names(self):
        """frozen={'s'} on a GR4J bundle must not also freeze
        'pr_history' (substring over-freezing regression)."""
        from rrmpg_jax.ops.gr4j import GR4JState

        n = 32
        rng = np.random.default_rng(0)
        state = GR4JState(s=jnp.asarray(rng.uniform(10, 50, n)),
                          r=jnp.asarray(rng.uniform(5, 20, n)),
                          pr_history=jnp.asarray(
                              rng.uniform(0, 5, (n, 6))))
        pred = np.asarray(state.s)
        new = enkf_update(state, pred, 30.0, 0.5,
                          jax.random.PRNGKey(1), frozen={'s'})
        np.testing.assert_array_equal(np.asarray(new.s),
                                      np.asarray(state.s))
        assert not np.allclose(np.asarray(new.pr_history),
                               np.asarray(state.pr_history))

    def test_postprocess_applied(self):
        key = jax.random.PRNGKey(4)
        n = 64
        state = ToyState(a=jnp.asarray(np.linspace(-1, 1, n)),
                         b=jnp.ones((n, 2)), g_thresh=jnp.ones(n))

        def clip_a(s):
            return s._replace(a=jnp.maximum(s.a, 0.0))

        new = enkf_update(state, np.asarray(state.a), 0.0, 10.0, key,
                          postprocess=clip_a)
        assert float(np.min(np.asarray(new.a))) >= 0.0


class TestPerturbState:
    def test_abs_std_spreads_zero_states(self):
        # Multiplicative factors alone leave zero components at zero;
        # abs_std provides the zero-safe floor.
        n = 1024
        state = ToyState(a=jnp.zeros(n), b=jnp.zeros((n, 2)),
                         g_thresh=jnp.zeros(n))
        mul_only = perturb_state(state, jax.random.PRNGKey(0),
                                 rel_std=0.5)
        np.testing.assert_array_equal(np.asarray(mul_only.a), 0.0)
        floored = perturb_state(state, jax.random.PRNGKey(0),
                                rel_std=0.5, abs_std=0.1)
        assert float(np.asarray(floored.a).std()) == pytest.approx(
            0.1, rel=0.1)
        np.testing.assert_array_equal(np.asarray(floored.g_thresh), 0.0)

    def test_mean_preserving_and_frozen(self):
        n = 8192
        state = ToyState(a=jnp.full(n, 10.0), b=jnp.full((n, 2), 4.0),
                         g_thresh=jnp.full(n, 2.0))
        new = perturb_state(state, jax.random.PRNGKey(0), rel_std=0.3)
        np.testing.assert_array_equal(np.asarray(new.g_thresh),
                                      np.asarray(state.g_thresh))
        assert float(np.asarray(new.a).mean()) == pytest.approx(10.0,
                                                                rel=0.02)
        assert float(np.asarray(new.a).std()) > 1.0
        assert float(np.asarray(new.a).min()) > 0.0  # lognormal: sign-safe


class TestParticleFilter:
    def test_matches_bayes_posterior(self):
        """Always-resampling PF with large N == exact conjugate update."""
        n = 200_000
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        x = 1.0 + np.asarray(jax.random.normal(k1, (n,)))  # N(1, 1)
        state = ToyState(a=jnp.asarray(x), b=jnp.zeros((n, 2)),
                         g_thresh=jnp.zeros(n))
        new, info = particle_filter_update(state, x, 2.0, 0.5, k2,
                                           ess_threshold=1.0)
        assert info.resampled
        a = np.asarray(new.a)
        # Conjugate posterior: precision 1/1 + 1/0.25.
        var_post = 1.0 / (1.0 + 4.0)
        mean_post = var_post * (1.0 * 1.0 + 4.0 * 2.0)
        assert a.mean() == pytest.approx(mean_post, abs=0.02)
        assert a.var() == pytest.approx(var_post, abs=0.02)

    def test_weights_and_ess_no_resample(self):
        n = 512
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, n)
        state = ToyState(a=jnp.asarray(x), b=jnp.zeros((n, 2)),
                         g_thresh=jnp.zeros(n))
        new, info = particle_filter_update(state, x, 0.0, 1.0,
                                           jax.random.PRNGKey(1),
                                           ess_threshold=0.0)
        assert not info.resampled
        np.testing.assert_array_equal(np.asarray(new.a),
                                      np.asarray(jnp.asarray(x)))
        w_manual = np.exp(-0.5 * x ** 2)
        w_manual /= w_manual.sum()
        np.testing.assert_allclose(info.weights, w_manual,
                                   atol=tol(1e-12, 1e-6))
        assert info.ess == pytest.approx(1.0 / np.sum(w_manual ** 2),
                                         rel=1e-6)

    def test_resampling_permutes_params_and_constants(self):
        n = 256
        rng = np.random.default_rng(1)
        x = rng.normal(0, 1, n)
        tag = np.arange(n, dtype=float)  # member identity
        state = ToyState(a=jnp.asarray(x), b=jnp.zeros((n, 2)),
                         g_thresh=jnp.asarray(tag))
        params = np.zeros(n, dtype=[('k', np.float64)])
        params['k'] = tag
        new, new_params, info = particle_filter_update(
            state, x, 3.0, 0.1, jax.random.PRNGKey(2), params=params,
            ess_threshold=1.0)
        assert info.resampled
        # Particles near the (far) observation get duplicated; the
        # constants and params rows travel with their particle.
        np.testing.assert_array_equal(np.asarray(new.g_thresh),
                                      new_params['k'])
        assert len(np.unique(new_params['k'])) < n
        picked = np.asarray(new.a)
        assert picked.mean() > x.mean()  # moved toward obs=3

    def test_jitter_rediversifies(self):
        n = 4096
        x = np.linspace(-3, 3, n)
        state = ToyState(a=jnp.asarray(x), b=jnp.ones((n, 2)),
                         g_thresh=jnp.full(n, 9.0))
        new, info = particle_filter_update(
            state, x, 3.0, 0.05, jax.random.PRNGKey(3),
            ess_threshold=1.0, jitter=0.1)
        a = np.asarray(new.a)
        assert info.resampled
        assert len(np.unique(a)) > n // 2  # jitter broke duplicates
        np.testing.assert_array_equal(np.asarray(new.g_thresh), 9.0)

    def test_single_member_rejected(self):
        state = ToyState(a=jnp.ones(1), b=jnp.ones((1, 2)),
                         g_thresh=jnp.ones(1))
        with pytest.raises(ValueError, match="N >= 2"):
            particle_filter_update(state, np.ones(1), 1.0, 1.0,
                                   jax.random.PRNGKey(0))

    def test_weights_accumulate_across_steps(self):
        """Two weak observations (no resample) must compound: the
        carried weights equal the normalized product of both
        likelihoods."""
        n = 256
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, n)
        state = ToyState(a=jnp.asarray(x), b=jnp.zeros((n, 2)),
                         g_thresh=jnp.zeros(n))
        # Huge obs error => tiny per-step information, never resamples.
        _, info1 = particle_filter_update(
            state, x, 1.0, 10.0, jax.random.PRNGKey(1),
            ess_threshold=0.0)
        assert not info1.resampled
        _, info2 = particle_filter_update(
            state, x, 2.0, 10.0, jax.random.PRNGKey(2),
            weights=info1.next_weights, ess_threshold=0.0)
        w_manual = np.exp(-0.5 * ((1.0 - x) / 10.0) ** 2
                          - 0.5 * ((2.0 - x) / 10.0) ** 2)
        w_manual /= w_manual.sum()
        np.testing.assert_allclose(info2.weights, w_manual,
                                   atol=tol(1e-12, 1e-6))
        # Regression: with forgotten (uniform) priors the second step
        # would only carry its own likelihood.
        w_single = np.exp(-0.5 * ((2.0 - x) / 10.0) ** 2)
        w_single /= w_single.sum()
        assert not np.allclose(info2.weights, w_single)

    def test_param_jitter_clipped_to_bounds(self):
        n = 128
        rng = np.random.default_rng(3)
        x = rng.normal(0, 1, n)
        state = ToyState(a=jnp.asarray(x), b=jnp.zeros((n, 2)),
                         g_thresh=jnp.zeros(n))
        params = {'k': np.full(n, 3.9)}
        _, new_params, info = particle_filter_update(
            state, x, 0.0, 0.05, jax.random.PRNGKey(4), params=params,
            ess_threshold=1.0, param_jitter=0.5,
            param_bounds={'k': (0.0, 4.0)})
        assert info.resampled
        k = np.asarray(new_params['k'])
        assert (k <= 4.0).all() and (k >= 0.0).all()
        assert len(np.unique(k)) > 1  # jitter applied

    def test_cycle_permutes_heterogeneous_params(self):
        """method='pf' without estimate_params: a heterogeneous
        parameter ensemble must stay aligned with its particles after
        resampling (params permute, values unchanged as a set)."""
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(5)
        T, window, n = 48, 12, 32
        prec = rng.gamma(0.8, 6.0, T)
        etp = rng.uniform(1, 4, T)
        base = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
        model = GR4J(params=base)
        obs = np.asarray(model.simulate(prec, etp, s_init=0.8,
                                        r_init=0.6))[:, 0]
        params_ens = {k: np.full(n, v) for k, v in base.items()}
        params_ens['x2'] = rng.uniform(-2, 2, n)  # heterogeneous

        _, params_out, _, diags = assimilation_cycle(
            model, {'prec': prec, 'etp': etp}, obs, window,
            obs_std=0.02, params=params_ens, seed=0,
            cold_start_kwargs={'s_init': 0.3, 'r_init': 0.3},
            method='pf', ess_threshold=1.0)  # force resampling
        x2_out = np.asarray(params_out['x2'])
        # Values are a multiset drawn (with duplication) from the
        # originals -- never invented, never left misaligned.  Compare by
        # distance (the computation dtype may be float32 in the f32 lane).
        gaps = np.abs(x2_out[:, None]
                      - np.asarray(params_ens['x2'])[None, :]).min(axis=1)
        assert (gaps < tol(1e-12, 1e-5)).all()
        assert len(np.unique(x2_out)) < n  # resampling duplicated some

    @pytest.mark.slow
    def test_pf_cycle_beats_free_run(self):
        """Twin experiment via method='pf' (mirrors the EnKF one)."""
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(42)
        T, window, n = 240, 12, 512
        prec = rng.gamma(0.8, 6.0, T)
        etp = rng.uniform(1, 4, T)
        truth_params = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
        model = GR4J(params=truth_params)
        q_true = np.asarray(model.simulate(prec, etp, s_init=0.9,
                                           r_init=0.7))[:, 0]
        obs = q_true + rng.normal(0, 0.02, T)
        params_ens = {k: np.full(n, v) for k, v in truth_params.items()}

        _, state0 = model.simulate(prec[:window], etp[:window],
                                   s_init=0.15, r_init=0.15,
                                   params=params_ens,
                                   return_final_state=True)
        state0 = perturb_state(state0, jax.random.PRNGKey(7),
                               rel_std=0.4)
        q_free = np.asarray(model.simulate(prec[window:], etp[window:],
                                           params=params_ens,
                                           initial_state=state0))
        state, params_out, q_prior, diags = assimilation_cycle(
            model, {'prec': prec[window:], 'etp': etp[window:]},
            obs[window:], window, obs_std=0.1, params=params_ens,
            seed=0, initial_state=state0, method='pf', jitter=0.15)
        truth_tail = q_true[window:]
        t0 = 5 * window
        err_pf = np.abs(q_prior[t0:].mean(axis=1) - truth_tail[t0:])
        err_free = np.abs(q_free[t0:].mean(axis=1) - truth_tail[t0:])
        assert err_pf.mean() < 0.5 * err_free.mean()
        assert diags.ess is not None and len(diags.ess) > 0

    def test_cycle_method_validation(self):
        from rrmpg_jax.models import GR4J

        model = GR4J(params={'x1': 300.0, 'x2': 1.0, 'x3': 90.0,
                             'x4': 1.7})
        ones = np.ones(30)
        pe = {k: np.full(4, v) for k, v in
              {'x1': 300.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}.items()}
        with pytest.raises(ValueError, match="method"):
            assimilation_cycle(model, {'prec': ones, 'etp': ones},
                               ones, window=10, obs_std=0.1, params=pe,
                               method='4dvar')


class TestGR4JTwinExperiment:
    @pytest.mark.slow
    def test_assimilation_beats_free_run(self):
        """Twin experiment: EnKF-corrected states track the truth.

        Truth: one GR4J run with known parameters and wet initial
        stores.  Ensemble: same parameters per member (state estimation
        only) but biased-dry initial stores.  Assimilating the
        window-end discharge must reduce the forecast discharge error
        relative to the free-running biased ensemble.
        """
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(42)
        T = 240
        window = 12
        prec = rng.gamma(0.8, 6.0, T)
        etp = rng.uniform(1, 4, T)
        truth_params = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}

        model = GR4J(params=truth_params)
        q_true = np.asarray(model.simulate(prec, etp, s_init=0.9,
                                           r_init=0.7))[:, 0]
        obs = q_true + rng.normal(0, 0.02, T)   # lightly noisy obs

        n = 64
        params_ens = {k: np.full(n, v) for k, v in truth_params.items()}

        # Biased-dry ensemble start with EnKF-required spread: a short
        # deterministic spin-up, then mean-preserving perturbations.
        _, state0 = model.simulate(prec[:window], etp[:window],
                                   s_init=0.15, r_init=0.15,
                                   params=params_ens,
                                   return_final_state=True)
        state0 = perturb_state(state0, jax.random.PRNGKey(7),
                               rel_std=0.4)

        def run_from(state):
            q = model.simulate(prec[window:], etp[window:],
                               params=params_ens, initial_state=state)
            return np.asarray(q)

        q_free = run_from(state0)

        state, _, q_prior, diags = assimilation_cycle(
            model, {'prec': prec[window:], 'etp': etp[window:]},
            obs[window:], window, obs_std=0.05, params=params_ens,
            seed=0, initial_state=state0)
        q_true = q_true[window:]

        # Compare the LATER windows (after the filter has had cycles to
        # correct the bias) against the free run.
        t0 = 5 * window
        t1 = q_prior.shape[0]
        err_da = np.abs(q_prior[t0:t1].mean(axis=1) - q_true[t0:t1])
        err_free = np.abs(q_free[t0:t1].mean(axis=1) - q_true[t0:t1])
        assert err_da.mean() < 0.5 * err_free.mean()

        # Innovations must shrink as the states converge.
        early = np.abs(diags.innovation[:3]).mean()
        late = np.abs(diags.innovation[-5:]).mean()
        assert late < early

        # The analysis state bundle keeps its structure and batch.
        assert np.asarray(state.s).shape == (n,)
        assert np.asarray(state.pr_history).shape[0] == n

    @pytest.mark.slow
    def test_joint_parameter_estimation(self):
        """Augmented-state EnKF: discharge observations recover x2.

        Truth has x2 = 1.5; the ensemble starts from a broad wrong
        prior around 0.  Joint cycling must contract the parameter
        ensemble toward the truth value.
        """
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(3)
        T, window, n = 240, 12, 256
        prec = rng.gamma(0.8, 6.0, T)
        etp = rng.uniform(1, 4, T)
        truth_params = {'x1': 320.0, 'x2': 1.5, 'x3': 90.0, 'x4': 1.7}
        model = GR4J(params=truth_params)
        q_true = np.asarray(model.simulate(prec, etp, s_init=0.5,
                                           r_init=0.5))[:, 0]
        obs = q_true + rng.normal(0, 0.02, T)

        params_ens = {k: np.full(n, v) for k, v in truth_params.items()}
        params_ens['x2'] = rng.normal(0.0, 1.0, n)  # broad wrong prior
        prior_err = abs(np.mean(params_ens['x2']) - 1.5)

        _, state0 = model.simulate(prec[:window], etp[:window],
                                   s_init=0.5, r_init=0.5,
                                   params=params_ens,
                                   return_final_state=True)
        state0 = perturb_state(state0, jax.random.PRNGKey(1),
                               rel_std=0.3)

        state, post_params, q_prior, diags = assimilation_cycle(
            model, {'prec': prec[window:], 'etp': etp[window:]},
            obs[window:], window, obs_std=0.05, params=params_ens,
            seed=0, initial_state=state0, estimate_params=True,
            param_bounds=model._default_bounds, inflation=1.02)

        post_err = abs(float(np.mean(np.asarray(post_params['x2'])))
                       - 1.5)
        assert post_err < 0.25 * prior_err
        # The x2 trajectory in the diagnostics moves monotonically-ish
        # toward the truth: last cycle closer than the first.
        x2_col = sorted(params_ens).index('x2')
        traj = diags.param_mean[:, x2_col]
        assert abs(traj[-1] - 1.5) < abs(traj[0] - 1.5)
        # Untouched parameters stay within their clip bounds.
        lo, hi = model._default_bounds['x2']
        assert (np.asarray(post_params['x2']) >= lo).all()
        assert (np.asarray(post_params['x2']) <= hi).all()

    def test_enkf_update_params_structured_roundtrip(self):
        key = jax.random.PRNGKey(0)
        n = 64
        state = ToyState(a=jnp.asarray(np.random.default_rng(0)
                                       .normal(0, 1, n)),
                         b=jnp.ones((n, 2)), g_thresh=jnp.ones(n))
        params = np.zeros(n, dtype=[('k1', np.float64),
                                    ('k2', np.float64)])
        params['k1'] = np.random.default_rng(1).normal(2.0, 0.5, n)
        params['k2'] = 5.0
        pred = np.asarray(state.a) + params['k1']
        new_state, new_params = enkf_update(
            state, pred, 2.0, 0.1, key, params=params,
            param_bounds={'k1': (0.0, 4.0)})
        assert isinstance(new_params, np.ndarray)
        assert new_params.dtype.names == ('k1', 'k2')
        # k1 covaries with the prediction => updated; k2 is degenerate
        # (zero variance) => unchanged.
        assert not np.allclose(new_params['k1'], params['k1'])
        np.testing.assert_allclose(new_params['k2'], 5.0)
        assert (new_params['k1'] >= 0.0).all()
        assert (new_params['k1'] <= 4.0).all()

    def test_estimate_params_requires_params(self):
        from rrmpg_jax.models import GR4J

        model = GR4J(params={'x1': 300.0, 'x2': 1.0, 'x3': 90.0,
                             'x4': 1.7})
        ones = np.ones(30)
        with pytest.raises(ValueError, match="params"):
            assimilation_cycle(model, {'prec': ones, 'etp': ones},
                               ones, window=10, obs_std=0.1,
                               estimate_params=True)

    def test_cycle_input_validation(self):
        from rrmpg_jax.models import GR4J

        model = GR4J(params={'x1': 300.0, 'x2': 1.0, 'x3': 90.0,
                             'x4': 1.7})
        prec = np.ones(30)
        with pytest.raises(ValueError, match="window"):
            assimilation_cycle(model, {'prec': prec, 'etp': prec},
                               np.ones(30), window=50, obs_std=0.1)
        with pytest.raises(ValueError, match="length"):
            assimilation_cycle(model, {'prec': prec,
                                       'etp': np.ones(20)},
                               np.ones(30), window=10, obs_std=0.1)
        with pytest.raises(ValueError, match="obs"):
            assimilation_cycle(model, {'prec': prec, 'etp': prec},
                               np.ones(25), window=10, obs_std=0.1)


class TestScanBackend:
    """backend='scan' (device-resident lax.scan cycling) must be
    numerically equivalent to the host loop, cycle for cycle."""

    def _gr4j_setup(self, n=32, T=240, window=12):
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(42)
        prec = rng.gamma(0.8, 6.0, T)
        etp = rng.uniform(1, 4, T)
        truth = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
        model = GR4J(params=truth)
        q_true = np.asarray(model.simulate(prec, etp, s_init=0.9,
                                           r_init=0.7))[:, 0]
        obs = q_true + rng.normal(0, 0.02, T)
        params_ens = {k: np.full(n, v) for k, v in truth.items()}
        _, st0 = model.simulate(prec[:window], etp[:window],
                                params=params_ens,
                                return_final_state=True)
        st0 = perturb_state(st0, jax.random.PRNGKey(7), rel_std=0.3)
        f = {'prec': prec[window:], 'etp': etp[window:]}
        return model, f, obs[window:], window, params_ens, st0

    def test_gr4j_scan_equals_host(self):
        model, f, obs, window, params_ens, st0 = self._gr4j_setup()
        common = dict(obs_std=0.02, params=params_ens, seed=0,
                      initial_state=st0)
        sh, _, qh, dh = assimilation_cycle(model, f, obs, window,
                                           **common)
        ss, _, qs, ds = assimilation_cycle(model, f, obs, window,
                                           backend='scan', **common)
        np.testing.assert_allclose(qs, qh, rtol=tol(1e-10, 1e-3),
                                   atol=tol(1e-12, 1e-5))
        np.testing.assert_allclose(ds.innovation, dh.innovation,
                                   rtol=tol(1e-10, 1e-3),
                                   atol=tol(1e-12, 1e-4))
        np.testing.assert_allclose(ds.posterior_mean, dh.posterior_mean,
                                   rtol=tol(1e-9, 1e-3),
                                   atol=tol(1e-11, 1e-4))
        for a, b in zip(jax.tree.leaves(ss), jax.tree.leaves(sh)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=tol(1e-9, 1e-3),
                                       atol=tol(1e-11, 1e-4))

    def test_gr4j_scan_estimate_params_equals_host(self):
        model, f, obs, window, params_ens, st0 = self._gr4j_setup()
        params_ens['x2'] = np.random.default_rng(1).uniform(-2, 2, 32)
        common = dict(obs_std=0.02, params=params_ens, seed=0,
                      initial_state=st0, estimate_params=True,
                      param_bounds=model._default_bounds)
        _, ph, qh, dh = assimilation_cycle(model, f, obs, window,
                                           **common)
        _, ps, qs, ds = assimilation_cycle(model, f, obs, window,
                                           backend='scan', **common)
        np.testing.assert_allclose(qs, qh, rtol=tol(1e-10, 1e-3),
                                   atol=tol(1e-12, 1e-5))
        np.testing.assert_allclose(ds.param_mean, dh.param_mean,
                                   rtol=tol(1e-9, 1e-3),
                                   atol=tol(1e-11, 1e-4))
        for k in ph:
            np.testing.assert_allclose(np.asarray(ps[k]),
                                       np.asarray(ph[k]),
                                       rtol=tol(1e-9, 1e-3),
                                       atol=tol(1e-11, 1e-4))

    def test_gr4j_pf_scan_equals_host(self):
        """Particle-filter cycling on the scan backend is numerically
        equivalent to the host loop cycle-for-cycle (same keys -> same
        weights, same resample decisions, same systematic indices)."""
        model, f, obs, window, params_ens, st0 = self._gr4j_setup()
        # Heterogeneous parameters so resampling permutations are
        # observable in the returned ensemble.
        params_ens['x2'] = np.random.default_rng(3).uniform(-2, 2, 32)
        common = dict(obs_std=0.02, params=params_ens, seed=0,
                      initial_state=st0, method='pf',
                      ess_threshold=0.7, jitter=0.1)
        sh, ph, qh, dh = assimilation_cycle(model, f, obs, window,
                                            **common)
        ss, ps, qs, ds = assimilation_cycle(model, f, obs, window,
                                            backend='scan', **common)
        assert dh.ess is not None and ds.ess is not None
        np.testing.assert_allclose(ds.ess, dh.ess,
                                   rtol=tol(1e-9, 1e-3))
        np.testing.assert_allclose(qs, qh, rtol=tol(1e-10, 1e-3),
                                   atol=tol(1e-12, 1e-5))
        np.testing.assert_allclose(ds.innovation, dh.innovation,
                                   rtol=tol(1e-9, 1e-3),
                                   atol=tol(1e-11, 1e-4))
        for k in ph:
            np.testing.assert_allclose(np.asarray(ps[k]),
                                       np.asarray(ph[k]),
                                       rtol=tol(1e-9, 1e-3),
                                       atol=tol(1e-11, 1e-4))
        for a, b in zip(jax.tree.leaves(ss), jax.tree.leaves(sh)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=tol(1e-9, 2e-3),
                                       atol=tol(1e-11, 1e-4))

    def test_gr4j_pf_scan_estimate_params_equals_host(self):
        """Joint state-parameter PF cycling (resample + parameter
        jitter + bounds clip) matches host, and the returned parameter
        ensemble is the resampling-permuted one on both backends."""
        model, f, obs, window, params_ens, st0 = self._gr4j_setup()
        params_ens['x2'] = np.random.default_rng(1).uniform(-2, 2, 32)
        common = dict(obs_std=0.02, params=params_ens, seed=0,
                      initial_state=st0, method='pf', jitter=0.15,
                      ess_threshold=1.0,  # force resampling every cycle
                      estimate_params=True,
                      param_bounds=model._default_bounds)
        _, ph, qh, dh = assimilation_cycle(model, f, obs, window,
                                           **common)
        _, ps, qs, ds = assimilation_cycle(model, f, obs, window,
                                           backend='scan', **common)
        np.testing.assert_allclose(qs, qh, rtol=tol(1e-10, 1e-3),
                                   atol=tol(1e-12, 1e-5))
        np.testing.assert_allclose(ds.param_mean, dh.param_mean,
                                   rtol=tol(1e-9, 1e-3),
                                   atol=tol(1e-11, 1e-4))
        for k in ph:
            np.testing.assert_allclose(np.asarray(ps[k]),
                                       np.asarray(ph[k]),
                                       rtol=tol(1e-9, 1e-3),
                                       atol=tol(1e-11, 1e-4))

    @pytest.mark.slow
    def test_snow_composition_scan_equals_host(self):
        from rrmpg_jax.models import CemaneigeHystGR4JIce

        rng = np.random.default_rng(5)
        T, window, n = 120, 12, 16
        mt = rng.uniform(-10, 15, T)
        forc = {'prec': rng.uniform(0, 15, T), 'mean_temp': mt,
                'min_temp': mt - 2.0, 'max_temp': mt + 2.0,
                'etp': rng.uniform(0, 4, T)}
        kw = dict(met_station_height=495,
                  altitudes=[550, 620, 700, 785, 920],
                  frac_ice=[0.1, 0.2, 0.3, 0.4, 0.5])
        model = CemaneigeHystGR4JIce()
        pe = model.get_random_params(n)
        names = ('prec', 'mean_temp', 'min_temp', 'max_temp', 'etp')
        _, st0 = model.simulate(*(forc[k][:window] for k in names),
                                params=pe, return_final_state=True,
                                **kw)
        f = {k: v[window:] for k, v in forc.items()}
        obs = rng.uniform(0, 5, T)[window:]
        common = dict(obs_std=0.05, params=pe, seed=0,
                      initial_state=st0, **kw)
        sh, _, qh, _ = assimilation_cycle(model, f, obs, window,
                                          **common)
        ss, _, qs, _ = assimilation_cycle(model, f, obs, window,
                                          backend='scan', **common)
        np.testing.assert_allclose(qs, qh, rtol=tol(1e-9, 2e-3),
                                   atol=tol(1e-11, 1e-4))
        for a, b in zip(jax.tree.leaves(ss), jax.tree.leaves(sh)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=tol(1e-9, 2e-3),
                                       atol=tol(1e-11, 1e-4))

    def test_scan_guards(self):
        model, f, obs, window, params_ens, st0 = self._gr4j_setup(n=4)
        with pytest.raises(ValueError, match="initial_state"):
            assimilation_cycle(model, f, obs, window, obs_std=0.02,
                               params=params_ens, backend='scan',
                               cold_start_kwargs={'s_init': 0.3})
        with pytest.raises(ValueError, match="backend"):
            assimilation_cycle(model, f, obs, window, obs_std=0.02,
                               params=params_ens, backend='device',
                               initial_state=st0)

    def test_scan_twin_experiment_beats_free_run(self):
        """The scan backend must actually assimilate: forecast RMSE of
        the cycled ensemble beats the free-running biased ensemble (the
        same twin contract as the host-path test)."""
        from rrmpg_jax.models import GR4J

        rng = np.random.default_rng(42)
        T, window, n = 240, 12, 128
        prec = rng.gamma(0.8, 6.0, T)
        etp = rng.uniform(1, 4, T)
        truth = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
        model = GR4J(params=truth)
        q_true = np.asarray(model.simulate(prec, etp, s_init=0.9,
                                           r_init=0.7))[:, 0]
        obs = q_true + rng.normal(0, 0.02, T)
        params_ens = {k: np.full(n, v) for k, v in truth.items()}
        # biased-dry start
        _, st0 = model.simulate(prec[:window], etp[:window],
                                params=params_ens, s_init=0.2,
                                r_init=0.2, return_final_state=True)
        st0 = perturb_state(st0, jax.random.PRNGKey(3), rel_std=0.4)
        f = {'prec': prec[window:], 'etp': etp[window:]}
        _, _, q_da, _ = assimilation_cycle(
            model, f, obs[window:], window, obs_std=0.02,
            params=params_ens, seed=0, initial_state=st0,
            backend='scan')
        q_free = np.asarray(model.simulate(
            prec[window:], etp[window:], params=params_ens,
            initial_state=st0))
        # Score after filter spin-in (first 3 cycles absorb the biased
        # start; the innovation has converged by then).
        skip = 3 * window
        rmse_da = np.sqrt(np.mean(
            (q_da[skip:].mean(axis=1) - q_true[window + skip:]) ** 2))
        rmse_free = np.sqrt(np.mean(
            (q_free[skip:].mean(axis=1) - q_true[window + skip:]) ** 2))
        assert rmse_da < 0.5 * rmse_free
