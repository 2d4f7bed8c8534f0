"""Regional (multi-catchment) execution tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.ops import run_gr4j
from rrmpg_jax.parallel import ensemble_catchment_mesh, regional_run

from lane import tol


def _kernel(prec, etp, params):
    return run_gr4j(prec, etp, 0.2, 0.2, params)


def _forcings(C=4, T=120, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 15, (C, T)), rng.uniform(0, 4, (C, T)))


def test_regional_shared_params():
    prec, etp = _forcings()
    params = {'x1': 350.0, 'x2': 1.0, 'x3': 90.0, 'x4': 2.0}
    qsim, s, r = regional_run(_kernel, (prec, etp), params)
    assert qsim.shape == (4, 120)
    for c in range(4):
        single = run_gr4j(prec[c], etp[c], 0.2, 0.2, params)
        assert np.allclose(np.asarray(qsim[c]), np.asarray(single[0]))


def test_regional_ensemble_params():
    prec, etp = _forcings()
    rng = np.random.default_rng(1)
    N = 6
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    qsim, s, r = regional_run(_kernel, (prec, etp), params)
    assert qsim.shape == (4, N, 120)
    single = run_gr4j(prec[2], etp[2],
                      0.2, 0.2, {k: v[3] for k, v in params.items()})
    assert np.allclose(np.asarray(qsim[2, 3]), np.asarray(single[0]))


def test_regional_on_two_axis_mesh():
    mesh = ensemble_catchment_mesh(ensemble=4, catchment=2)
    prec, etp = _forcings(C=4)
    rng = np.random.default_rng(2)
    N = 8
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    q_mesh, _, _ = regional_run(_kernel, (prec, etp), params, mesh=mesh)
    q_plain, _, _ = regional_run(_kernel, (prec, etp), params)
    assert np.allclose(np.asarray(q_mesh), np.asarray(q_plain))


def test_regional_gr4j_objective_engines_agree():
    import jax.numpy as jnp
    from rrmpg_jax.parallel.regional import regional_gr4j_objective

    rng = np.random.default_rng(13)
    C, T, N = 2, 200, 6
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0, 5, (C, T))
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    l_xla = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3, params,
                                    engine="xla")
    l_pal = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3, params,
                                    engine="pallas", interpret=True,
                                    num_uh1=3, num_uh2=7)
    assert l_pal.shape == (C, N)
    assert np.allclose(np.asarray(l_pal), np.asarray(l_xla),
                       rtol=tol(1e-8, 5e-3), atol=tol(1e-10, 1e-4))


def test_regional_gr4j_objective_mesh_shard_map():
    import jax
    import jax.numpy as jnp
    from rrmpg_jax.parallel.mesh import ensemble_catchment_mesh
    from rrmpg_jax.parallel.regional import regional_gr4j_objective

    mesh = ensemble_catchment_mesh(ensemble=4, catchment=2)
    rng = np.random.default_rng(14)
    C, T, N = 4, 150, 8
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0, 5, (C, T))
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    l_plain = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3, params,
                                      engine="xla")
    l_mesh = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3, params,
                                     engine="xla", mesh=mesh)
    assert np.allclose(np.asarray(l_mesh), np.asarray(l_plain),
                       rtol=1e-10)


def test_regional_gr4j_objective_fused_under_mesh():
    # The multi-card configuration: the fused Pallas regional kernel
    # under shard_map on the 2-D (ensemble, catchment) mesh.  Must agree
    # with (a) the single-device fused result and (b) the sharded XLA
    # result -- the kernel and the sharding proven *together*.
    import jax.numpy as jnp
    from rrmpg_jax.parallel.mesh import ensemble_catchment_mesh
    from rrmpg_jax.parallel.regional import regional_gr4j_objective

    mesh = ensemble_catchment_mesh(ensemble=4, catchment=2)
    rng = np.random.default_rng(15)
    C, T, N = 4, 150, 8
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0, 5, (C, T))
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    kw = dict(engine="pallas", interpret=True, 
              num_uh1=3, num_uh2=7)
    l_fused_mesh = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3,
                                           params, mesh=mesh, **kw)
    l_fused = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3, params,
                                      **kw)
    l_xla_mesh = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3,
                                         params, engine="xla", mesh=mesh)
    assert l_fused_mesh.shape == (C, N)
    # Sharding must not change the fused kernel's result at all.
    assert np.array_equal(np.asarray(l_fused_mesh), np.asarray(l_fused))
    assert np.allclose(np.asarray(l_fused_mesh), np.asarray(l_xla_mesh),
                       rtol=tol(1e-8, 5e-3), atol=tol(1e-10, 1e-4))


def test_regional_gr4j_objective_loss_metrics():
    # nse/kge regional sweeps: the fused sufficient-statistics path must
    # match per-catchment XLA metrics, including on gapped records.
    import jax
    from rrmpg_jax.ops.gr4j import run_gr4j
    from rrmpg_jax.parallel.regional import regional_gr4j_objective
    from rrmpg_jax.utils.metrics import kge, nse

    rng = np.random.default_rng(17)
    C, T, N = 3, 180, 6
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0.5, 5, (C, T))
    qobs[1, rng.choice(T, 25, replace=False)] = np.nan   # gapped gauge
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    for metric, fn in (("kge", kge), ("nse", nse), ("rmse", None)):
        l_pal = np.asarray(regional_gr4j_objective(
            prec, etp, qobs, 0.3, 0.3, params, engine="pallas",
            interpret=True, loss_metric=metric, num_uh1=3,
            num_uh2=7))
        l_xla = np.asarray(regional_gr4j_objective(
            prec, etp, qobs, 0.3, 0.3, params, engine="xla",
            loss_metric=metric))
        assert l_pal.shape == (C, N)
        assert np.allclose(l_pal, l_xla, rtol=tol(1e-7, 5e-3),
                           atol=tol(1e-9, 1e-3)), metric
        # spot-check one pair against the plain metric
        if fn is not None:
            p = {k: float(v[2]) for k, v in params.items()}
            q, _, _ = run_gr4j(prec[1], etp[1], 0.3, 0.3, p)
            exp = 1.0 - float(fn(jnp.asarray(qobs[1]), q))
            assert np.isclose(l_xla[1, 2], exp,
                              rtol=tol(1e-10, 1e-4)), metric


def test_regional_gr4j_objective_kge_under_mesh():
    import jax.numpy as jnp
    from rrmpg_jax.parallel.mesh import ensemble_catchment_mesh
    from rrmpg_jax.parallel.regional import regional_gr4j_objective

    mesh = ensemble_catchment_mesh(ensemble=4, catchment=2)
    rng = np.random.default_rng(18)
    C, T, N = 4, 150, 8
    prec = rng.uniform(0, 15, (C, T))
    etp = rng.uniform(0, 4, (C, T))
    qobs = rng.uniform(0.5, 5, (C, T))
    params = {'x1': jnp.asarray(rng.uniform(100, 1200, N)),
              'x2': jnp.asarray(rng.uniform(-5, 3, N)),
              'x3': jnp.asarray(rng.uniform(20, 300, N)),
              'x4': jnp.asarray(rng.uniform(1.1, 2.9, N))}
    kw = dict(engine="pallas", interpret=True, loss_metric="kge",
              num_uh1=3, num_uh2=7)
    l_mesh = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3, params,
                                     mesh=mesh, **kw)
    l_single = regional_gr4j_objective(prec, etp, qobs, 0.3, 0.3,
                                       params, **kw)
    assert np.allclose(np.asarray(l_mesh), np.asarray(l_single),
                       rtol=1e-12)
