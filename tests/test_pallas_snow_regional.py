"""Regional (catchment x member) snow-family fused kernel parity."""

import jax.numpy as jnp
import numpy as np
import pytest

from lane import tol

from rrmpg_jax.ops import (run_cemaneigegr4j, run_cemaneigehystgr4j,
                           run_cemaneigehystgr4jice)
from rrmpg_jax.ops.pallas_snow import snowgr4j_regional_mse_pallas

pytestmark = pytest.mark.slow


def _inputs(C=2, T=250, L=3, N=5, seed=5):
    rng = np.random.default_rng(seed)
    prec = jnp.asarray(rng.uniform(0, 20, (C, T, L)))
    temp = jnp.asarray(rng.uniform(-10, 12, (C, T, L)))
    frac = jnp.asarray(rng.uniform(0, 1, (C, T, L)))
    etp = jnp.asarray(rng.uniform(0, 4, (C, T)))
    qobs = jnp.asarray(rng.uniform(0, 5, (C, T)))
    fi = jnp.asarray(rng.uniform(0, 0.5, (C, L)))
    params = {
        'CTG': jnp.asarray(rng.uniform(0, 1, N)),
        'Kf': jnp.asarray(rng.uniform(0, 10, N)),
        'Thacc': jnp.asarray(rng.uniform(1, 1000, N)),
        'Rsp': jnp.asarray(rng.uniform(0, 1, N)),
        'x1': jnp.asarray(rng.uniform(100, 1200, N)),
        'x2': jnp.asarray(rng.uniform(-5, 3, N)),
        'x3': jnp.asarray(rng.uniform(20, 300, N)),
        'x4': jnp.asarray(rng.uniform(1.1, 2.9, N)),
        'DDF': jnp.asarray(rng.uniform(0, 30, N)),
    }
    return prec, temp, frac, etp, qobs, fi, params


def test_regional_snow_plain_matches_xla():
    prec, temp, frac, etp, qobs, fi, params = _inputs()
    C, N = prec.shape[0], params['CTG'].shape[0]
    losses = snowgr4j_regional_mse_pallas(
        prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2, params,
        num_uh1=3, num_uh2=7, interpret=True)
    assert losses.shape == (C, N)
    for c in range(C):
        for i in range(N):
            p = {k: v[i] for k, v in params.items()}
            q, *_ = run_cemaneigegr4j(prec[c], temp[c], etp[c], frac[c],
                                      0.0, 0.0, 0.2, 0.2, p)
            mse = float(jnp.mean((q - qobs[c]) ** 2))
            assert np.isclose(float(losses[c, i]), mse, rtol=tol(1e-10, 1e-3))


def test_regional_snow_hyst_ice_per_catchment_frac_ice():
    prec, temp, frac, etp, qobs, fi, params = _inputs(seed=6)
    C, N = prec.shape[0], params['CTG'].shape[0]
    losses = snowgr4j_regional_mse_pallas(
        prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2, params,
        frac_ice=fi, hyst=True, ice=True, num_uh1=3,
        num_uh2=7, interpret=True)
    for c in range(C):
        for i in range(N):
            p = {k: v[i] for k, v in params.items()}
            q, *_ = run_cemaneigehystgr4jice(
                prec[c], temp[c], etp[c], fi[c], frac[c], 0.0, 0.0, 0.0,
                0.2, 0.2, p)
            mse = float(jnp.mean((q - qobs[c]) ** 2))
            assert np.isclose(float(losses[c, i]), mse, rtol=tol(1e-10, 1e-3))


def test_regional_snow_objective_helper():
    from rrmpg_jax.parallel.regional import regional_snow_objective

    prec, temp, frac, etp, qobs, fi, params = _inputs(seed=9)
    C, N = prec.shape[0], params['CTG'].shape[0]
    losses = regional_snow_objective(
        prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2, params,
        frac_ice=fi, hyst=True, ice=True, interpret=True, 
        num_uh1=3, num_uh2=7)
    assert losses.shape == (C, N)
    # spot-check one pair against the XLA composition
    p0 = {k: v[0] for k, v in params.items()}
    q, *_ = run_cemaneigehystgr4jice(prec[0], temp[0], etp[0], fi[0],
                                     frac[0], 0.0, 0.0, 0.0, 0.2, 0.2,
                                     p0)
    mse = float(jnp.mean((q - qobs[0]) ** 2))
    assert np.isclose(float(losses[0, 0]), mse, rtol=tol(1e-10, 1e-3))


def test_regional_snow_objective_fused_under_mesh():
    # Multi-card configuration for the snow family: the fused Pallas
    # regional kernel under shard_map on the 2-D (ensemble, catchment)
    # mesh.  Sharding must be a pure layout change (bit-identical to the
    # single-device fused run) and agree with the sharded XLA engine.
    import jax
    from rrmpg_jax.parallel.mesh import ensemble_catchment_mesh
    from rrmpg_jax.parallel.regional import regional_snow_objective
    from rrmpg_jax.parallel.regional import regional_run

    mesh = ensemble_catchment_mesh(ensemble=4, catchment=2)
    prec, temp, frac, etp, qobs, fi, params = _inputs(C=2, T=96, L=2, N=8,
                                                      seed=11)
    kw = dict(frac_ice=fi, hyst=True, ice=True, interpret=True,
              num_uh1=3, num_uh2=7)
    l_mesh = regional_snow_objective(prec, temp, etp, frac, qobs,
                                     0.0, 0.0, 0.2, 0.2, params,
                                     mesh=mesh, **kw)
    l_single = regional_snow_objective(prec, temp, etp, frac, qobs,
                                       0.0, 0.0, 0.2, 0.2, params, **kw)
    assert l_mesh.shape == (2, 8)
    assert np.array_equal(np.asarray(l_mesh), np.asarray(l_single))
    # Cross-engine: the golden-validated XLA composition, vmapped and
    # sharded over the same mesh axes via regional_run.
    def xla_kernel(pr, mt, et, fs, fi1, qo, p):
        q, *_ = run_cemaneigehystgr4jice(pr, mt, et, fi1, fs, 0.0, 0.0,
                                         0.0, 0.2, 0.2, p)
        return jnp.mean((q - qo) ** 2)
    l_xla = regional_run(xla_kernel, (prec, temp, etp, frac, fi, qobs),
                         params, mesh=mesh)[0]
    assert np.allclose(np.asarray(l_mesh), np.asarray(l_xla),
                       rtol=tol(1e-10, 5e-3), atol=tol(1e-12, 1e-4))


def test_regional_snow_fuzz_shapes():
    # Random catchment/layer/member shapes: the regional kernel must agree
    # with the golden-validated XLA compositions for a random member and
    # catchment in each configuration.
    rng = np.random.default_rng(31)
    for trial in range(4):
        C = int(rng.integers(1, 5))
        L = int(rng.integers(1, 6))
        T = int(rng.integers(80, 400))
        N = int(rng.integers(1, 9))
        prec = jnp.asarray(rng.uniform(0, 20, (C, T, L)))
        temp = jnp.asarray(rng.uniform(-10, 12, (C, T, L)))
        frac = jnp.asarray(rng.uniform(0, 1, (C, T, L)))
        etp = jnp.asarray(rng.uniform(0, 4, (C, T)))
        qobs = jnp.asarray(rng.uniform(0, 5, (C, T)))
        params = {
            'CTG': jnp.asarray(rng.uniform(0, 1, N)),
            'Kf': jnp.asarray(rng.uniform(0, 10, N)),
            'Thacc': jnp.asarray(rng.uniform(1, 1000, N)),
            'Rsp': jnp.asarray(rng.uniform(0, 1, N)),
            'x1': jnp.asarray(rng.uniform(100, 1200, N)),
            'x2': jnp.asarray(rng.uniform(-5, 3, N)),
            'x3': jnp.asarray(rng.uniform(20, 300, N)),
            'x4': jnp.asarray(rng.uniform(1.1, 2.9, N)),
            'DDF': jnp.asarray(rng.uniform(0, 30, N)),
        }
        losses = snowgr4j_regional_mse_pallas(
            prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2, params,
            hyst=True, num_uh1=3, num_uh2=7, interpret=True)
        c = int(rng.integers(0, C))
        i = int(rng.integers(0, N))
        p = {k: v[i] for k, v in params.items()}
        q, *_ = run_cemaneigehystgr4j(prec[c], temp[c], etp[c], frac[c],
                                      0.0, 0.0, 0.0, 0.2, 0.2, p)
        mse = float(jnp.mean((q - qobs[c]) ** 2))
        assert np.isclose(float(losses[c, i]), mse, rtol=tol(1e-10, 1e-3)), (
            trial, C, L, T, N, c, i)


def test_regional_snow_objective_loss_metric_kge():
    # Regional KGE sweep through the fused sufficient-statistics path
    # vs the per-catchment XLA metric, on a gapped gauge.
    from rrmpg_jax.parallel.regional import regional_snow_objective
    from rrmpg_jax.utils.metrics import kge

    prec, temp, frac, etp, qobs, fi, params = _inputs(C=2, T=120, L=2,
                                                      N=5, seed=13)
    qobs = np.asarray(qobs).copy()
    rng = np.random.default_rng(2)
    qobs[0, rng.choice(qobs.shape[1], 15, replace=False)] = np.nan
    losses = np.asarray(regional_snow_objective(
        prec, temp, etp, frac, qobs, 0.0, 0.0, 0.2, 0.2, params,
        frac_ice=fi, hyst=True, ice=True, interpret=True,
        loss_metric="kge", num_uh1=3, num_uh2=7))
    assert losses.shape == (2, 5)
    assert np.isfinite(losses).all()
    for c in range(2):
        for i in (0, 3):
            p = {k: float(v[i]) for k, v in params.items()}
            q, *_ = run_cemaneigehystgr4jice(
                prec[c], temp[c], etp[c], fi[c], frac[c], 0.0, 0.0,
                0.0, 0.2, 0.2, p)
            exp = 1.0 - float(kge(jnp.asarray(qobs[c]), q))
            assert np.isclose(losses[c, i], exp,
                              rtol=tol(1e-7, 5e-3)), (c, i)
