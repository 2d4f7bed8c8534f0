"""Checkpoint/resume tests for calibration state."""

import numpy as np
import pytest

from rrmpg_jax.tools import (
    differential_evolution,
    load_checkpoint,
    save_checkpoint,
)


def test_checkpoint_roundtrip(tmp_path):
    path = str(tmp_path / "state.npz")
    state = {'pop': np.random.uniform(size=(8, 3)),
             'energies': np.random.uniform(size=8),
             'nit': np.asarray(17)}
    save_checkpoint(path, state, metadata={'model': 'gr4j'})
    loaded = load_checkpoint(path)
    assert np.allclose(loaded['pop'], state['pop'])
    assert int(loaded['nit']) == 17
    assert str(loaded['metadata']['model']) == 'gr4j'


def test_de_checkpoint_resume_matches_uninterrupted(tmp_path):
    import jax.numpy as jnp

    target = jnp.asarray([0.5, -2.0])

    def objective(x):
        return jnp.sum((x - target) ** 2)

    bounds = [(-5, 5)] * 2
    full = differential_evolution(objective, bounds, seed=7, maxiter=40,
                                  tol=0.0)

    path = str(tmp_path / "de.npz")
    # Run 15 generations with checkpointing...
    differential_evolution(objective, bounds, seed=7, maxiter=15, tol=0.0,
                           checkpoint_path=path, checkpoint_every=5)
    # ...then resume to 40 total.
    resumed = differential_evolution(objective, bounds, seed=7, maxiter=40,
                                     tol=0.0, resume_from=path)
    assert resumed.nit == full.nit == 40
    # Same seed + same chunked RNG stream => identical evolution.
    assert np.allclose(resumed.x, full.x)
    assert np.allclose(resumed.population_energies,
                       full.population_energies)


def test_de_chunked_equals_monolithic():
    import jax.numpy as jnp

    def objective(x):
        return jnp.sum(x ** 2)

    bounds = [(-3, 3)] * 2
    mono = differential_evolution(objective, bounds, seed=3, maxiter=30,
                                  tol=0.0)
    chunked = differential_evolution(objective, bounds, seed=3, maxiter=30,
                                     tol=0.0, checkpoint_every=7)
    assert np.allclose(mono.x, chunked.x)
    assert mono.nit == chunked.nit


def test_orbax_roundtrip(tmp_path):
    import jax.numpy as jnp
    from rrmpg_jax.tools.checkpoint import (
        load_checkpoint_orbax,
        save_checkpoint_orbax,
    )

    state = {'pop': jnp.arange(12.0).reshape(3, 4),
             'energies': jnp.asarray([1.0, 2.0, 3.0]),
             'nit': jnp.asarray(7)}
    path = str(tmp_path / 'ckpt')
    save_checkpoint_orbax(path, state)
    restored = load_checkpoint_orbax(path)
    for k in state:
        assert np.allclose(np.asarray(restored[k]), np.asarray(state[k]))


def test_de_checkpoint_resume_with_mesh(tmp_path):
    # The sharded-population resume branch: interrupted evolution on a
    # mesh must continue bit-identically to an uninterrupted run.
    import jax.numpy as jnp
    from rrmpg_jax.parallel.mesh import default_mesh
    from rrmpg_jax.tools.calibration import differential_evolution

    mesh = default_mesh()
    target = jnp.asarray([0.2, -0.8, 1.5, 0.4])
    bounds = [(-2, 2), (-2, 2), (0, 3), (-1, 1)]

    def obj(x):
        return jnp.sum((x - target) ** 2)

    path = str(tmp_path / "de_mesh.npz")
    full = differential_evolution(obj, bounds, seed=5, popsize=16,
                                  maxiter=12, tol=0.0, mesh=mesh)
    differential_evolution(obj, bounds, seed=5, popsize=16, maxiter=6,
                           tol=0.0, mesh=mesh, checkpoint_path=path,
                           checkpoint_every=6)
    resumed = differential_evolution(obj, bounds, seed=5, popsize=16,
                                     maxiter=12, tol=0.0, mesh=mesh,
                                     resume_from=path)
    assert resumed.nit == full.nit
    assert np.allclose(resumed.population, full.population)
    assert np.allclose(resumed.x, full.x)


def test_de_orbax_checkpoint_resume(tmp_path):
    # Non-.npz checkpoint paths route through the Orbax backend.
    import jax.numpy as jnp
    from rrmpg_jax.tools.calibration import differential_evolution

    target = jnp.asarray([0.5, -0.5])
    bounds = [(-2, 2), (-2, 2)]

    def obj(x):
        return jnp.sum((x - target) ** 2)

    path = str(tmp_path / "de_orbax_ckpt")
    full = differential_evolution(obj, bounds, seed=2, maxiter=10,
                                  tol=0.0)
    differential_evolution(obj, bounds, seed=2, maxiter=5, tol=0.0,
                           checkpoint_path=path, checkpoint_every=5)
    resumed = differential_evolution(obj, bounds, seed=2, maxiter=10,
                                     tol=0.0, resume_from=path)
    assert resumed.nit == full.nit
    assert np.allclose(resumed.population, full.population)


def test_state_bundle_roundtrip(tmp_path):
    """save_state/load_state round-trips flat and nested bundles and the
    loaded bundle drives a warm continuation identically."""
    import jax.numpy as jnp

    from rrmpg_jax.models import GR4J, CemaneigeGR4J
    from rrmpg_jax.tools.checkpoint import load_state, save_state

    rng = np.random.default_rng(0)
    T, n = 60, 4
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    params = {'x1': np.full(n, 320.0), 'x2': np.full(n, 1.0),
              'x3': np.full(n, 90.0), 'x4': np.full(n, 1.7)}
    m = GR4J()
    _, st = m.simulate(prec[:30], etp[:30], params=params,
                       return_final_state=True)
    p = tmp_path / "state.npz"
    save_state(p, st)
    st2 = load_state(p)
    assert type(st2).__name__ == "GR4JState"
    q_a = m.simulate(prec[30:], etp[30:], params=params,
                     initial_state=st)
    q_b = m.simulate(prec[30:], etp[30:], params=params,
                     initial_state=st2)
    np.testing.assert_array_equal(q_a, q_b)

    # Nested snow composition bundle.
    snow = CemaneigeGR4J(params={'CTG': 0.25, 'Kf': 3.5, 'x1': 320.0,
                                 'x2': 1.0, 'x3': 90.0, 'x4': 1.7})
    mean_t = rng.uniform(-8, 10, T)
    kw = dict(met_station_height=500,
              altitudes=[400, 600, 800, 1000, 1200])
    _, sst = snow.simulate(prec[:30], mean_t[:30], mean_t[:30] - 3,
                           mean_t[:30] + 3, etp[:30],
                           return_final_state=True, **kw)
    p2 = tmp_path / "snow_state.npz"
    save_state(p2, sst)
    sst2 = load_state(p2)
    assert type(sst2).__name__ == "SnowGR4JState"
    np.testing.assert_array_equal(np.asarray(sst.snow.g_thresh),
                                  np.asarray(sst2.snow.g_thresh))
    q_a = snow.simulate(prec[30:], mean_t[30:], mean_t[30:] - 3,
                        mean_t[30:] + 3, etp[30:], initial_state=sst,
                        **kw)
    q_b = snow.simulate(prec[30:], mean_t[30:], mean_t[30:] - 3,
                        mean_t[30:] + 3, etp[30:], initial_state=sst2,
                        **kw)
    np.testing.assert_array_equal(q_a, q_b)

    with pytest.raises(TypeError, match="state bundle"):
        save_state(tmp_path / "x.npz", {"not": "a bundle"})
    with pytest.raises(ValueError, match="bundle"):
        from rrmpg_jax.tools.checkpoint import save_checkpoint
        save_checkpoint(tmp_path / "plain.npz", {'a': np.ones(3)})
        load_state(tmp_path / "plain.npz")
