"""Property and equivalence tests beyond the reference's coverage:

* zero rain => zero discharge, negative rain => ValueError (reference
  parity, ``test/test_models.py:90-99``),
* vmap-batched ensembles == per-set loops (the serial loop the batched
  engine replaces),
* ABC associative-scan (parallel prefix) == sequential scan,
* batched output shape conventions.
"""

import numpy as np
import pytest

from rrmpg_jax.models import ABCModel, GR4J, HBVEdu
from rrmpg_jax.ops import (
    run_abcmodel,
    run_abcmodel_matscan,
    run_abcmodel_pscan,
    run_gr4j,
)

from lane import tol


def test_abc_simulate_zero_rain():
    qsim = ABCModel().simulate(np.zeros(100))
    assert np.sum(qsim) == 0


def test_abc_simulate_negative_rain():
    with pytest.raises(ValueError, match="negative values"):
        ABCModel().simulate([-1, 1, 1])


def test_gr4j_simulate_zero_rain():
    model = GR4J()
    qsim = model.simulate(prec=np.zeros(100),
                          etp=np.random.uniform(0, 3, 100),
                          s_init=0, r_init=0)
    assert np.sum(qsim) == 0


def test_gr4j_negative_rain():
    with pytest.raises(ValueError, match="negative values"):
        GR4J().simulate([-1, 1, 1], [1, 1, 1])


def test_gr4j_size_mismatch():
    with pytest.raises(RuntimeError):
        GR4J().simulate([1, 1, 1], [1, 1])


def test_gr4j_init_out_of_range():
    with pytest.raises(ValueError):
        GR4J().simulate([1, 1], [1, 1], s_init=1.5)


def test_hbv_simulate_zero_rain():
    params = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
    model = HBVEdu(params=params)
    qsim = model.simulate(temp=np.random.uniform(-15, 25, 100),
                          prec=np.zeros(100),
                          month=np.random.randint(1, 12, 100),
                          PE_m=np.random.uniform(0, 4, 12),
                          T_m=np.random.uniform(-5, 15, 12))
    assert np.sum(qsim) == 0


def test_hbv_negative_rain():
    params = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
    with pytest.raises(ValueError, match="negative values"):
        HBVEdu(params=params).simulate(
            temp=np.random.uniform(-15, 25, 100),
            prec=np.arange(-1, 99),
            month=np.random.randint(1, 12, 100),
            PE_m=np.random.uniform(0, 4, 12),
            T_m=np.random.uniform(-5, 15, 12))


def test_hbv_month_out_of_range():
    params = {'T_t': 0, 'DD': 4.25, 'FC': 177.1, 'Beta': 2.35, 'C': 0.02,
              'PWP': 105.89, 'K_0': 0.05, 'K_1': 0.03, 'K_2': 0.02,
              'K_p': 0.05, 'L': 4.87}
    with pytest.raises(ValueError):
        HBVEdu(params=params).simulate(
            temp=np.zeros(10), prec=np.zeros(10),
            month=np.zeros(10, dtype=int),  # 0 is invalid (must be 1..12)
            PE_m=np.zeros(12), T_m=np.zeros(12))


def test_abc_pscan_equals_scan():
    rng = np.random.default_rng(0)
    prec = rng.uniform(0, 20, 4096)
    params = {'a': 0.3, 'b': 0.2, 'c': 0.15}
    q_seq, s_seq = run_abcmodel(prec, 3.0, params)
    q_par, s_par = run_abcmodel_pscan(prec, 3.0, params)
    assert np.allclose(np.asarray(q_seq), np.asarray(q_par))
    assert np.allclose(np.asarray(s_seq), np.asarray(s_par))


@pytest.mark.parametrize("T", [1, 5, 127, 128, 129, 5000, 100001])
def test_abc_matscan_equals_scan(T):
    # Toeplitz-matmul path vs the sequential oracle,
    # incl. chunk-boundary sizes and multi-level recursion depths.
    rng = np.random.default_rng(T)
    prec = rng.uniform(0, 20, T)
    params = {'a': 0.3, 'b': 0.4, 'c': 0.1}
    q_seq, s_seq = run_abcmodel(prec, 5.0, params)
    q_mat, s_mat = run_abcmodel_matscan(prec, 5.0, params)
    assert np.allclose(np.asarray(q_seq), np.asarray(q_mat))
    assert np.allclose(np.asarray(s_seq), np.asarray(s_mat))


@pytest.mark.parametrize("c", [0.0, 1.0])
def test_abc_matscan_edge_coefficients(c):
    # alpha = 1 - c hits 1 (no decay) and 0 (full drain).
    rng = np.random.default_rng(9)
    prec = rng.uniform(0, 20, 1000)
    params = {'a': 0.3, 'b': 0.4, 'c': c}
    q_seq, s_seq = run_abcmodel(prec, 5.0, params)
    q_mat, s_mat = run_abcmodel_matscan(prec, 5.0, params)
    assert np.allclose(np.asarray(s_seq), np.asarray(s_mat))
    assert np.allclose(np.asarray(q_seq), np.asarray(q_mat))


def test_gr4j_vmap_equals_loop():
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    N = 6
    params = {'x1': rng.uniform(100, 1200, N),
              'x2': rng.uniform(-5, 3, N),
              'x3': rng.uniform(20, 300, N),
              'x4': rng.uniform(1.1, 2.9, N)}
    prec = rng.uniform(0, 15, 300)
    etp = rng.uniform(0, 4, 300)

    batched = jax.vmap(lambda p: run_gr4j(prec, etp, 0.4, 0.2, p))(
        {k: jnp.asarray(v) for k, v in params.items()})
    for i in range(N):
        single = run_gr4j(prec, etp, 0.4, 0.2,
                          {k: v[i] for k, v in params.items()})
        for b, s in zip(batched, single):
            assert np.allclose(np.asarray(b[i]), np.asarray(s),
                                rtol=tol(1e-5, 1e-3), atol=tol(1e-8, 1e-4))


def test_batched_simulate_shapes_and_order():
    model = GR4J()
    params = model.get_random_params(num=5)
    prec = np.random.uniform(0, 10, 120)
    etp = np.random.uniform(0, 3, 120)
    qsim = model.simulate(prec, etp, params=params)
    assert qsim.shape == (120, 5)
    # column i must equal the single-set simulation of params[i]
    q2 = model.simulate(prec, etp, params=params[2:3])
    assert np.allclose(qsim[:, 2], q2[:, 0])


def test_simulate_batched_all_sets_without_storage():
    # The reference returns only the first parameter set when
    # return_storage=False (quirk, rrmpg/models/gr4j.py:176-178); this
    # framework always simulates all sets -- documented divergence.
    model = GR4J()
    params = model.get_random_params(num=4)
    qsim = model.simulate(np.random.uniform(0, 10, 50),
                          np.random.uniform(0, 3, 50), params=params)
    assert qsim.shape == (50, 4)
    assert not np.allclose(qsim[:, 0], qsim[:, 3])
