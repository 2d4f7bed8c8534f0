"""NSGA-II multi-objective calibration: benchmark + invariant tests.

Validated on the ZDT suite (known Pareto fronts: convex, non-convex)
plus unit tests of the dominance/ranking/crowding building blocks and a
bi-objective hydrological calibration smoke.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lane import tol

from rrmpg_jax.tools.moo import _dominance, _nondominated_ranks, nsga2


def zdt1(x):
    f1 = x[0]
    g = 1.0 + 9.0 * jnp.mean(x[1:])
    return jnp.stack([f1, g * (1.0 - jnp.sqrt(f1 / g))])


def zdt2(x):
    f1 = x[0]
    g = 1.0 + 9.0 * jnp.mean(x[1:])
    return jnp.stack([f1, g * (1.0 - (f1 / g) ** 2)])


class TestBuildingBlocks:
    def test_dominance_matrix(self):
        F = jnp.asarray([[0.0, 0.0],    # dominates everyone
                         [1.0, 0.0],    # incomparable with [0, 1]
                         [0.0, 1.0],
                         [1.0, 1.0]])   # dominated by all others
        dom = np.asarray(_dominance(F))
        assert dom[0, 1] and dom[0, 2] and dom[0, 3]
        assert not dom[1, 2] and not dom[2, 1]
        assert dom[1, 3] and dom[2, 3]
        assert not dom.diagonal().any()

    def test_dominance_nonfinite_quarantine(self):
        F = jnp.asarray([[1.0, 1.0], [jnp.nan, 0.0], [jnp.inf, 2.0]])
        dom = np.asarray(_dominance(F))
        # Non-finite members never dominate and are dominated by the
        # finite one.
        assert not dom[1].any() and not dom[2].any()
        assert dom[0, 1] and dom[0, 2]

    def test_rank_peeling(self):
        F = jnp.asarray([[0.0, 3.0], [3.0, 0.0],      # front 0
                         [1.0, 4.0], [4.0, 1.0],      # front 1
                         [5.0, 5.0]])                  # front 2
        ranks = np.asarray(_nondominated_ranks(F))
        np.testing.assert_array_equal(ranks, [0, 0, 1, 1, 2])


class TestZDT:
    def test_zdt1_convex_front(self):
        res = nsga2(zdt1, [(0.0, 1.0)] * 10, pop_size=100,
                    n_generations=150, seed=0)
        f = res.f
        # Convergence: mean vertical distance to the true front.
        d = np.abs(f[:, 1] - (1.0 - np.sqrt(f[:, 0])))
        assert d.mean() < 0.01
        # Spread: the front covers most of f1's [0, 1] range.
        assert f[:, 0].min() < 0.05 and f[:, 0].max() > 0.95
        assert res.nfev == 100 * 151
        # Every reported front member is rank 0 and mutually
        # non-dominated.
        dom = np.asarray(_dominance(jnp.asarray(f)))
        assert not dom.any()

    @pytest.mark.slow
    def test_zdt2_nonconvex_front(self):
        # A weighted-sum scalarization can only reach the endpoints of
        # a non-convex front; NSGA-II must populate its interior.
        res = nsga2(zdt2, [(0.0, 1.0)] * 10, pop_size=100,
                    n_generations=200, seed=1)
        f = res.f
        d = np.abs(f[:, 1] - (1.0 - f[:, 0] ** 2))
        assert d.mean() < 0.02
        interior = (f[:, 0] > 0.2) & (f[:, 0] < 0.8)
        assert interior.sum() > 10

    def test_deterministic_and_batched(self):
        r1 = nsga2(zdt1, [(0.0, 1.0)] * 4, pop_size=32,
                   n_generations=20, seed=3)
        r2 = nsga2(zdt1, [(0.0, 1.0)] * 4, pop_size=32,
                   n_generations=20, seed=3)
        np.testing.assert_array_equal(r1.population, r2.population)

        r3 = nsga2(jax.vmap(zdt1), [(0.0, 1.0)] * 4, pop_size=32,
                   n_generations=20, seed=3, batched=True)
        np.testing.assert_allclose(r3.population, r1.population,
                                   rtol=1e-12)

    def test_bounds_respected_and_odd_popsize(self):
        res = nsga2(zdt1, [(0.2, 0.9)] * 3, pop_size=33,
                    n_generations=10, seed=0)
        assert res.population.shape == (34, 3)  # rounded up to even
        assert (res.population >= 0.2 - 1e-12).all()
        assert (res.population <= 0.9 + 1e-12).all()

    def test_nonfinite_objectives_never_on_front(self):
        def guarded(x):
            f = zdt1(x)
            return jnp.where(x[0] > 0.5, jnp.nan, f)

        res = nsga2(guarded, [(0.0, 1.0)] * 4, pop_size=32,
                    n_generations=30, seed=5)
        assert np.isfinite(res.f).all()


class TestFitQSCAPareto:
    @pytest.mark.slow
    def test_front_and_validation(self):
        from rrmpg_jax.models import CemaneigeHystGR4J
        from rrmpg_jax.tools.moo import ParetoResult

        rng = np.random.default_rng(0)
        T = 150
        mean_t = rng.uniform(-8, 10, T)
        kw = dict(met_station_height=495,
                  altitudes=[550, 620, 700, 785, 920])
        forc = dict(prec=rng.gamma(0.8, 6.0, T), mean_temp=mean_t,
                    min_temp=mean_t - 3, max_temp=mean_t + 3,
                    etp=rng.uniform(0.5, 3, T))
        model = CemaneigeHystGR4J()
        truth = model.get_random_params()
        qsim = model.simulate(**forc, params=truth, **kw)[:, 0]
        ndsi = {f'NDSI{i}': np.clip(rng.uniform(0, 100, T), 0, 100)
                for i in range(1, 6)}

        res = model.fit_Q_SCA(qsim, **forc, **ndsi, **kw, seed=0,
                              pareto=True, pop_size=16,
                              n_generations=5)
        assert isinstance(res, ParetoResult)
        assert res.f.shape[1] == 2
        assert np.isfinite(res.f).all()
        assert res.x.shape[0] >= 1

        # Fused-engine Pareto fit (interpret mode on CPU) produces a
        # valid front through the same API.
        res_p = model.fit_Q_SCA(qsim, **forc, **ndsi, **kw, seed=0,
                                pareto=True, engine='pallas',
                                interpret=True, pop_size=16,
                                n_generations=3)
        assert isinstance(res_p, ParetoResult)
        assert np.isfinite(res_p.f).all()

    @pytest.mark.slow
    def test_fused_components_match_xla(self):
        """The fused (L_q, L_sca) components equal the XLA objective's
        on identical parameter batches (kge metric, interpret mode)."""
        import jax.numpy as jnp

        from rrmpg_jax.models import CemaneigeHystGR4J
        from rrmpg_jax.ops.compositions import run_cemaneigehystgr4j
        from rrmpg_jax.utils.metrics import kge as jkge

        rng = np.random.default_rng(1)
        T = 128
        mean_t = rng.uniform(-8, 10, T)
        kw = dict(met_station_height=495,
                  altitudes=[550, 620, 700, 785, 920])
        forc = dict(prec=rng.gamma(0.8, 6.0, T), mean_temp=mean_t,
                    min_temp=mean_t - 3, max_temp=mean_t + 3,
                    etp=rng.uniform(0.5, 3, T))
        model = CemaneigeHystGR4J()
        qobs = model.simulate(**forc, params=model.get_random_params(),
                              **kw)[:, 0]
        ndsi_arr = np.clip(rng.uniform(0, 100, (5, T)), 0, 100)

        (prec, mt, fsp, etp, *_inits, ndsi) = model._prepare(
            forc['prec'], forc['mean_temp'], forc['min_temp'],
            forc['max_temp'], forc['etp'], kw['met_station_height'],
            kw['altitudes'], 0, 0, 0, 0, 0,
            extra_series=tuple((f'NDSI{i+1}', ndsi_arr[i])
                               for i in range(5)))

        fused = model._pallas_q_sca_objective(
            'kge', prec, mt, etp, fsp, np.asarray(qobs), ndsi, 0.0,
            0.0, 0.0, 0.0, interpret=True, components=True)

        X = np.column_stack([
            rng.uniform(*model._default_bounds[p], 8)
            for p in model._param_list])
        got = np.asarray(fused(jnp.asarray(X)))

        args = tuple(jnp.asarray(a) for a in (prec, mt, etp, fsp))
        ndsi_j = jnp.stack([jnp.asarray(n) for n in ndsi])
        for j in range(8):
            params = {n: X[j, i]
                      for i, n in enumerate(model._param_list)}
            qsim, _, _, _, _, sca, _ = run_cemaneigehystgr4j(
                *args, 0.0, 0.0, 0.0, 0.0, 0.0, params)
            lq = 1.0 - jkge(jnp.asarray(qobs), qsim)
            bands = 100.0 * sca.T
            ls = sum(1.0 - jkge(ndsi_j[b], bands[b]) for b in range(5))
            np.testing.assert_allclose(got[j, 0], float(lq),
                                       rtol=tol(1e-8, 3e-3),
                                       atol=tol(0, 1e-3))
            np.testing.assert_allclose(got[j, 1], float(ls),
                                       rtol=tol(1e-8, 3e-3),
                                       atol=tol(0, 1e-3))


class TestHydrologyBiObjective:
    @pytest.mark.slow
    def test_gr4j_highflow_vs_lowflow_tradeoff(self):
        """Calibrate GR4J against two conflicting error measures (MSE on
        raw discharge ~ high flows, MSE on log discharge ~ low flows)
        and check the front exposes a real tradeoff containing
        near-specialist solutions at both ends."""
        from rrmpg_jax.ops.gr4j import run_gr4j
        from rrmpg_jax.utils.metrics import mse

        rng = np.random.default_rng(0)
        T = 400
        prec = jnp.asarray(rng.gamma(0.7, 7.0, T))
        etp = jnp.asarray(rng.uniform(1, 4, T))
        # Observations from a "wrong structure" truth (different UH
        # depth) so no single parameter set can be perfect on both.
        q_true, _, _ = run_gr4j(prec * 1.1, etp, 0.3, 0.4,
                                {'x1': 500.0, 'x2': -1.0, 'x3': 150.0,
                                 'x4': 2.5})
        qobs = jnp.maximum(q_true, 1e-3)

        def objectives(x):
            params = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
            qsim, _, _ = run_gr4j(prec, etp, 0.3, 0.4, params,
                                  num_uh1=3, num_uh2=7)
            qsim = jnp.maximum(qsim, 1e-3)
            return jnp.stack([mse(qobs, qsim),
                              mse(jnp.log(qobs), jnp.log(qsim))])

        bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]
        res = nsga2(objectives, bounds, pop_size=64, n_generations=40,
                    seed=0)
        f = res.f
        assert np.isfinite(f).all()
        assert f.shape[0] >= 5  # a real front, not a single point
        # The front's best-MSE and best-logMSE members differ: a
        # genuine tradeoff, which the reference's fixed scalarization
        # cannot expose.
        i_hi = int(np.argmin(f[:, 0]))
        i_lo = int(np.argmin(f[:, 1]))
        assert i_hi != i_lo
        assert f[i_hi, 1] > f[i_lo, 1]
        assert f[i_lo, 0] > f[i_hi, 0]


class TestHypervolume:
    def test_exact_areas(self):
        from rrmpg_jax.tools.moo import hypervolume_2d

        assert hypervolume_2d([[0.0, 0.0]], [1.0, 1.0]) == 1.0
        assert hypervolume_2d([[0.0, 0.5], [0.5, 0.0]],
                              [1.0, 1.0]) == 0.75
        # Dominated and out-of-reference points contribute nothing.
        assert hypervolume_2d([[0.0, 0.5], [0.5, 0.0], [0.6, 0.6],
                               [2.0, -1.0], [np.nan, 0.0]],
                              [1.0, 1.0]) == 0.75
        assert hypervolume_2d([[2.0, 2.0]], [1.0, 1.0]) == 0.0
        with pytest.raises(ValueError):
            hypervolume_2d([[0.0, 0.0, 0.0]], [1.0, 1.0])

    def test_improves_over_generations(self):
        from rrmpg_jax.tools.moo import hypervolume_2d

        r_short = nsga2(zdt1, [(0.0, 1.0)] * 6, pop_size=48,
                        n_generations=5, seed=0)
        r_long = nsga2(zdt1, [(0.0, 1.0)] * 6, pop_size=48,
                       n_generations=60, seed=0)
        ref = [1.5, 10.0]
        assert (hypervolume_2d(r_long.f, ref)
                > hypervolume_2d(r_short.f, ref))
