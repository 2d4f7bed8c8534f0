"""Pin the documented divergences from reference quirks.

Round-1 review finding: the quirk-parity decisions (inert ``sca_init``,
KGE loss-sign fix) were documented but not pinned by tests, so a
regression in either direction would be invisible.  These tests assert
the *chosen* semantics explicitly.
"""

import numpy as np
import pytest


def test_kge_fit_loss_is_one_minus_kge():
    # Reference quirk: CemaneigeHystGR4J's plain `_loss` with 'kge'
    # minimizes calc_kge DIRECTLY (rrmpg/models/cemaneigehystgr4j.py:
    # 608-609 -- i.e. it drives KGE toward -inf, the wrong direction),
    # while its `_loss_Q_SCA` correctly minimizes 1 - KGE.  This
    # framework deliberately uses 1 - KGE everywhere; pin it.
    import jax.numpy as jnp

    from rrmpg_jax.models.cemaneigehystgr4j import _loss_fn
    from rrmpg_jax.utils.metrics import calc_kge

    rng = np.random.default_rng(0)
    obs = rng.uniform(1, 10, 500)
    good_sim = obs + rng.normal(0, 0.1, 500)   # KGE near 1
    bad_sim = rng.uniform(1, 10, 500)          # KGE well below 1

    loss = _loss_fn("kge")
    l_good = float(loss(jnp.asarray(obs), jnp.asarray(good_sim)))
    l_bad = float(loss(jnp.asarray(obs), jnp.asarray(bad_sim)))

    # 1 - KGE semantics: perfect simulation -> loss ~ 0; better sim
    # must give LOWER loss (the reference's raw-KGE direction would
    # invert this ordering).
    assert np.isclose(l_good, 1.0 - calc_kge(obs, good_sim), atol=1e-6)
    assert l_good < l_bad
    assert l_good < 0.2


def test_hyst_sca_init_is_inert():
    # Reference parity: sca_init is assigned at t=0 but unconditionally
    # overwritten before any read (cemaneigehyst_model.py:100-143), so
    # two different values must produce bit-identical trajectories.
    from rrmpg_jax.ops.cemaneige import run_cemaneigehyst

    rng = np.random.default_rng(1)
    T, L = 200, 3
    prec = rng.uniform(0, 20, (T, L))
    temp = rng.uniform(-10, 10, (T, L))
    frac = rng.uniform(0, 1, (T, L))
    params = {'CTG': 0.3, 'Kf': 4.0, 'Thacc': 50.0, 'Rsp': 0.3}

    out_a = run_cemaneigehyst(prec, temp, frac, 0.0, 0.0, 0.0, params)
    out_b = run_cemaneigehyst(prec, temp, frac, 0.0, 0.0, 0.9, params)
    for a, b in zip(out_a, out_b):
        assert np.array_equal(np.asarray(a), np.asarray(b))
