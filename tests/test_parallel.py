"""Sharded-ensemble tests on a virtual 8-device CPU mesh.

Validates that GSPMD-sharded ensemble evaluation is numerically identical
to the unsharded vmap path -- the multi-device contract a multi-card
deployment relies on.
"""

import jax
import numpy as np
import pytest

from rrmpg_jax.models import GR4J
from rrmpg_jax.ops import run_gr4j
from rrmpg_jax.parallel import (
    default_mesh,
    ensemble_catchment_mesh,
    ensemble_objective,
    ensemble_run,
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return default_mesh()


def _random_params(n, seed=0):
    rng = np.random.default_rng(seed)
    import jax.numpy as jnp
    return {'x1': jnp.asarray(rng.uniform(100, 1200, n)),
            'x2': jnp.asarray(rng.uniform(-5, 3, n)),
            'x3': jnp.asarray(rng.uniform(20, 300, n)),
            'x4': jnp.asarray(rng.uniform(1.1, 2.9, n))}


def test_sharded_ensemble_matches_unsharded(mesh):
    rng = np.random.default_rng(1)
    prec = rng.uniform(0, 15, 200)
    etp = rng.uniform(0, 4, 200)
    params = _random_params(16)

    sharded = ensemble_run(run_gr4j, (prec, etp, 0.3, 0.3), params, mesh)
    unsharded = jax.vmap(
        lambda p: run_gr4j(prec, etp, 0.3, 0.3, p))(params)
    for s, u in zip(sharded, unsharded):
        assert np.allclose(np.asarray(s), np.asarray(u))


def test_sharded_ensemble_with_padding(mesh):
    # 13 is not divisible by 8 -> exercises the padding path.
    rng = np.random.default_rng(2)
    prec = rng.uniform(0, 15, 100)
    etp = rng.uniform(0, 4, 100)
    params = _random_params(13)

    sharded = ensemble_run(run_gr4j, (prec, etp, 0.0, 0.0), params, mesh)
    assert sharded[0].shape == (13, 100)
    unsharded = jax.vmap(lambda p: run_gr4j(prec, etp, 0.0, 0.0, p))(params)
    assert np.allclose(np.asarray(sharded[0]), np.asarray(unsharded[0]))


def test_ensemble_objective_argmin(mesh):
    rng = np.random.default_rng(3)
    prec = rng.uniform(0, 15, 150)
    etp = rng.uniform(0, 4, 150)
    params = _random_params(16, seed=7)
    # target = member 5's simulation
    target = np.asarray(jax.vmap(
        lambda p: run_gr4j(prec, etp, 0.2, 0.2, p))(params)[0][5])

    losses, best_idx, best_loss = ensemble_objective(
        run_gr4j, (prec, etp, 0.2, 0.2), params, target, mesh)
    assert int(best_idx) == 5
    assert float(best_loss) < 1e-20


def test_model_simulate_with_mesh(mesh):
    model = GR4J()
    params = model.get_random_params(num=16)
    prec = np.random.uniform(0, 10, 100)
    etp = np.random.uniform(0, 3, 100)
    q_mesh = model.simulate(prec, etp, params=params, mesh=mesh)
    q_plain = model.simulate(prec, etp, params=params)
    assert np.allclose(q_mesh, q_plain)


def test_two_axis_mesh():
    mesh = ensemble_catchment_mesh(ensemble=4, catchment=2)
    assert mesh.shape == {'ensemble': 4, 'catchment': 2}


def test_regional_vmap_over_catchments():
    # "Regional mode": batch over catchments with a second vmap axis.
    rng = np.random.default_rng(4)
    C, T = 3, 100
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    params = {'x1': 350.0, 'x2': 1.0, 'x3': 90.0, 'x4': 2.0}

    regional = jax.vmap(
        lambda pr, e: run_gr4j(pr, e, 0.1, 0.1, params))(prec, etp)
    for c in range(C):
        single = run_gr4j(prec[c], etp[c], 0.1, 0.1, params)
        assert np.allclose(np.asarray(regional[0][c]), np.asarray(single[0]))


def test_de_mesh_matches_unsharded(mesh):
    # Population size 16*4=64 is a multiple of 8 devices, so the sharded
    # run sees the identical population and must evolve identically.
    import jax.numpy as jnp
    from rrmpg_jax.tools.calibration import differential_evolution

    target = jnp.asarray([0.5, -1.0, 2.0, 0.1])
    bounds = [(-2, 2), (-3, 3), (0, 5), (-1, 1)]

    def obj(x):
        return jnp.sum((x - target) ** 2)

    r_plain = differential_evolution(obj, bounds, seed=3, popsize=16,
                                     maxiter=25)
    r_mesh = differential_evolution(obj, bounds, seed=3, popsize=16,
                                    maxiter=25, mesh=mesh)
    assert r_mesh.population.shape == r_plain.population.shape
    assert np.allclose(r_mesh.x, r_plain.x)
    assert np.isclose(r_mesh.fun, r_plain.fun)


def test_de_mesh_batched_shard_map(mesh):
    import jax.numpy as jnp
    from rrmpg_jax.tools.calibration import differential_evolution

    target = jnp.asarray([0.5, -1.0, 2.0, 0.1])
    bounds = [(-2, 2), (-3, 3), (0, 5), (-1, 1)]

    def batched_obj(X):
        return jnp.sum((X - target[None, :]) ** 2, axis=1)

    r = differential_evolution(batched_obj, bounds, seed=3, popsize=16,
                               maxiter=40, batched=True, mesh=mesh)
    assert np.allclose(r.x, np.asarray(target), atol=5e-2)


def test_gr4j_fit_with_mesh(mesh):
    # model.fit(..., mesh=) -- the flagship calibration workload sharded
    # over the population axis.
    rng = np.random.default_rng(8)
    prec = rng.uniform(0, 12, 200)
    etp = rng.uniform(0, 4, 200)
    truth = GR4J(params={'x1': 320., 'x2': 1.0, 'x3': 90., 'x4': 1.9})
    qobs = truth.simulate(prec, etp).flatten()
    res = GR4J().fit(qobs, prec, etp, seed=0, maxiter=4, mesh=mesh)
    assert res.population.shape[0] % 8 == 0
    assert np.isfinite(res.fun)


@pytest.mark.slow
def test_gr4j_fit_pallas_engine_with_mesh(mesh):
    # The flagship combination: fused Pallas ensemble objective sharded
    # over the mesh via shard_map (each device evaluates its population
    # shard with the fused kernel in interpret mode).
    rng = np.random.default_rng(8)
    prec = rng.uniform(0, 12, 200)
    etp = rng.uniform(0, 4, 200)
    truth = GR4J(params={'x1': 320., 'x2': 1.0, 'x3': 90., 'x4': 1.9})
    qobs = truth.simulate(prec, etp).flatten()
    res = GR4J().fit(qobs, prec, etp, seed=0, maxiter=3, engine="pallas",
                     interpret=True, mesh=mesh)
    assert res.population.shape[0] % 8 == 0
    assert np.isfinite(res.fun)


def test_random_search_with_mesh(mesh):
    import jax
    import jax.numpy as jnp
    from rrmpg_jax.tools.calibration import random_search

    target = jnp.asarray([0.4, -0.6])

    def obj(x):
        return jnp.sum((x - target) ** 2)

    def sample(key, n):
        return jax.random.uniform(key, (n, 2), minval=-2.0, maxval=2.0)

    res = random_search(obj, sample, num=4096, seed=0, batch_size=1024,
                        mesh=mesh)
    plain = random_search(obj, sample, num=4096, seed=0, batch_size=1024)
    assert np.allclose(res.x, plain.x)
    assert np.isclose(res.fun, plain.fun)
    assert np.allclose(res.x, np.asarray(target), atol=0.1)
