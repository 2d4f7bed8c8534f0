"""Regression tests for review findings (NaN-robust DE, UH truncation)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.models import GR4J
from rrmpg_jax.ops import run_gr4j
from rrmpg_jax.tools import differential_evolution, random_search


def test_de_ignores_nan_candidates():
    # NaN objective region must neither poison 'best' selection nor
    # shield incumbents; the result must be the finite optimum.
    def objective(x):
        val = jnp.sum((x - 0.2) ** 2)
        return jnp.where(x[0] > 0.5, jnp.nan, val)

    res = differential_evolution(objective, [(0, 1)] * 2, seed=0,
                                 maxiter=100)
    assert np.isfinite(res.fun)
    assert res.fun < 1e-6
    assert np.allclose(res.x, [0.2, 0.2], atol=1e-3)


def test_random_search_all_nan_batches():
    def objective(x):
        return jnp.nan * jnp.sum(x)

    def sample(key, n):
        import jax
        return jax.random.uniform(key, (n, 2))

    res = random_search(objective, sample, 64, seed=0, batch_size=16)
    assert not res.success
    assert res.x is None


def test_gr4j_large_x4_not_truncated():
    # x4 > 10 exceeds the default static UH caps; the class must size the
    # registers dynamically so no routed water is lost (reference
    # allocates ceil(x4)/ceil(2*x4+1) dynamically, gr4j_model.py:67-69).
    rng = np.random.default_rng(0)
    T = 400
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    params = {'x1': 300.0, 'x2': 1.0, 'x3': 100.0, 'x4': 12.0}

    qsim = GR4J(params=params).simulate(prec, etp)[:, 0]

    # Oracle with explicitly sufficient register lengths.
    q_ref, _, _ = run_gr4j(jnp.asarray(prec), jnp.asarray(etp), 0.0, 0.0,
                           params, num_uh1=12, num_uh2=25)
    assert np.allclose(qsim, np.asarray(q_ref))

    try:
        from rrmpg_jax import native
        if native.available():
            q_cpp, _, _ = native.oracle_gr4j(prec, etp, 0.0, 0.0, params)
            assert np.allclose(qsim, q_cpp)
    except ImportError:
        pass


def test_de_distinct_mutation_indices_still_converges():
    # Sanity: the distinct-r1/r2 sampler still optimizes correctly.
    def objective(x):
        return jnp.sum(x ** 2)

    res = differential_evolution(objective, [(-2, 2)] * 3, seed=1)
    assert res.fun < 1e-8


def test_pallas_engine_rejects_mesh():
    # The pallas simulate branches must refuse a mesh instead of silently
    # running single-device.
    from rrmpg_jax.models import GR4J
    from rrmpg_jax.parallel.mesh import default_mesh

    with pytest.raises(ValueError, match="mesh"):
        GR4J().simulate(np.ones(100), np.ones(100), engine="pallas",
                        interpret=True, mesh=default_mesh())


def test_load_basins_rejects_disjoint_periods(tmp_path):
    import shutil
    from pathlib import Path

    from rrmpg_jax.data import CAMELSLoader

    src = Path('rrmpg_jax/data/camels')
    fname = '01031500_lump_cida_forcing_leap.txt'
    oname = '01031500_05_model_output.txt'
    # basin A = bundled years; basin B = same data shifted 400 years
    # (the Gregorian leap cycle, keeping Feb 29 rows valid) via
    # rewriting the year column of both files.
    for basin in ('aaaa', 'bbbb'):
        for name in (fname, oname):
            text = (src / name).read_text().splitlines()
            if basin == 'bbbb':
                hdr = 4 if name == fname else 1
                body = []
                for ln in text[hdr:]:
                    parts = ln.split()
                    if parts:
                        parts[0] = str(int(parts[0]) + 400)
                    body.append(' '.join(parts))
                text = text[:hdr] + body
            (tmp_path / name.replace('01031500', basin)).write_text(
                '\n'.join(text))

    loader = CAMELSLoader(data_dir=str(tmp_path))
    with pytest.raises(ValueError, match="no common dates"):
        loader.load_basins()
