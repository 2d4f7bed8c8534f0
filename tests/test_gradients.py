"""Differentiability: gradients flow through every model kernel.

The reference (numba kernels + scipy DE) has no gradients at all; here
every kernel is built from `where`-based branchless primitives, so
gradient-based calibration is possible.  These tests pin that property:
finite, nonzero parameter gradients of an MSE objective.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrmpg_jax.ops import (
    run_abcmodel,
    run_cemaneigegr4j,
    run_gr4j,
    run_hbvedu,
)


def _check_grads(loss_fn, params):
    grads = jax.grad(loss_fn)(params)
    for name, g in grads.items():
        g = float(g)
        assert np.isfinite(g), f"non-finite grad for {name}"
    assert any(abs(float(g)) > 0 for g in grads.values())


def test_abc_gradients():
    rng = np.random.default_rng(0)
    prec = jnp.asarray(rng.uniform(0, 20, 300))
    qobs = jnp.asarray(rng.uniform(0, 3, 300))

    def loss(params):
        qsim, _ = run_abcmodel(prec, 2.0, params)
        return jnp.mean((qsim - qobs) ** 2)

    _check_grads(loss, {'a': 0.3, 'b': 0.2, 'c': 0.15})


def test_gr4j_gradients():
    rng = np.random.default_rng(1)
    prec = jnp.asarray(rng.uniform(0, 15, 300))
    etp = jnp.asarray(rng.uniform(0, 4, 300))
    qobs = jnp.asarray(rng.uniform(0, 5, 300))

    def loss(params):
        qsim, _, _ = run_gr4j(prec, etp, 0.4, 0.3, params)
        return jnp.mean((qsim - qobs) ** 2)

    _check_grads(loss, {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1})


def test_hbv_gradients():
    rng = np.random.default_rng(2)
    T = 250
    temp = jnp.asarray(rng.uniform(-10, 20, T))
    prec = jnp.asarray(rng.uniform(0, 15, T))
    month = jnp.asarray(rng.integers(0, 12, T))
    pe_m = jnp.asarray(rng.uniform(0.5, 4, 12))
    t_m = jnp.asarray(rng.uniform(-5, 15, 12))
    qobs = jnp.asarray(rng.uniform(0, 3, T))

    def loss(params):
        qsim, *_ = run_hbvedu(temp, prec, month, pe_m, t_m, 0.0, 100.0,
                              3.0, 10.0, params)
        return jnp.mean((qsim - qobs) ** 2)

    _check_grads(loss, {'T_t': 0.2, 'DD': 4.5, 'FC': 150.0, 'Beta': 2.2,
                        'C': 0.03, 'PWP': 110.0, 'K_0': 0.1, 'K_1': 0.05,
                        'K_2': 0.02, 'K_p': 0.03, 'L': 3.0})


def test_cemaneigegr4j_gradients():
    rng = np.random.default_rng(3)
    T, L = 250, 5
    prec = jnp.asarray(rng.uniform(0, 15, (T, L)))
    temp = jnp.asarray(rng.uniform(-10, 15, (T, L)))
    frac = jnp.asarray(np.clip(rng.uniform(-0.3, 1.2, (T, L)), 0, 1))
    etp = jnp.asarray(rng.uniform(0, 4, T))
    qobs = jnp.asarray(rng.uniform(0, 5, T))

    def loss(params):
        qsim, *_ = run_cemaneigegr4j(prec, temp, etp, frac, 2.0, -1.0,
                                     0.4, 0.3, params)
        return jnp.mean((qsim - qobs) ** 2)

    _check_grads(loss, {'CTG': 0.3, 'Kf': 3.7, 'x1': 300.0, 'x2': 1.0,
                        'x3': 90.0, 'x4': 2.0})


@pytest.mark.slow
def test_gradient_descent_improves_gr4j_fit():
    # A few Adam steps on the MSE objective must reduce it -- the basis
    # for gradient-based calibration (impossible in the reference).
    import optax

    rng = np.random.default_rng(4)
    prec = jnp.asarray(rng.uniform(0, 15, 400))
    etp = jnp.asarray(rng.uniform(0, 4, 400))
    true = {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}
    qobs = run_gr4j(prec, etp, 0.3, 0.3, true)[0]

    def loss(params):
        qsim, _, _ = run_gr4j(prec, etp, 0.3, 0.3, params)
        return jnp.mean((qsim - qobs) ** 2)

    params = {'x1': jnp.asarray(400.0), 'x2': jnp.asarray(0.5),
              'x3': jnp.asarray(120.0), 'x4': jnp.asarray(1.8)}
    opt = optax.adam(1e-1)
    state = opt.init(params)
    initial = float(loss(params))

    @jax.jit
    def step(params, state):
        val, grads = jax.value_and_grad(loss)(params)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(params, updates), state, val

    for _ in range(60):
        params, state, val = step(params, state)
    assert float(val) < 0.5 * initial
