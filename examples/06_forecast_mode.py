"""Operational forecast mode: warm-state continuation.

No reference counterpart -- its ``*_init`` arguments cover only the
stores, so a split run never reproduces an unbroken one.  Here the full
state (GR4J stores + unit-hydrograph filter history; per-layer snowpack
states) carries across segment boundaries exactly: calibrate on history,
then step the model forward day by day (or batch by batch) as new
forcing arrives, without ever re-running the past.

Captured output::

    unbroken vs 5 chained segments: max |dq| = 0.00e+00
    day-by-day loop (30 single-step continuations): max |dq| vs unbroken = 0.00e+00
    class API (GR4J): history + forecast vs unbroken: max |dq| = 0.00e+00
    class API (CemaneigeGR4J): chained snow forecast segments: max |dq| = 0.00e+00
    recalibration on the last 300 days: warm-fit MSE 1.10e-06 vs cold-start 3.33e+00
"""

import numpy as np

from rrmpg_jax.ops import GR4JState, gr4j_initial_state, run_gr4j_warm


def main():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    T = 1000
    prec = jnp.asarray(rng.uniform(0, 15, T), jnp.float32)
    etp = jnp.asarray(rng.uniform(0, 4, T), jnp.float32)
    params = {'x1': 320.0, 'x2': 1.1, 'x3': 90.0, 'x4': 2.3}

    # One unbroken simulation.
    state0 = gr4j_initial_state(0.4, 0.6, params, num_uh2=7,
                                dtype=jnp.float32)
    q_full, _, _, _ = run_gr4j_warm(prec, etp, state0, params,
                                    num_uh1=3, num_uh2=7)

    # The same series as 5 chained segments (e.g. weekly forecast cycles).
    qs, state = [], state0
    for lo in range(0, T, 200):
        q, _, _, state = run_gr4j_warm(prec[lo:lo + 200],
                                       etp[lo:lo + 200], state, params,
                                       num_uh1=3, num_uh2=7)
        qs.append(np.asarray(q))
    q_chained = np.concatenate(qs)
    print(f"unbroken vs 5 chained segments: "
          f"max |dq| = {np.abs(q_chained - np.asarray(q_full)).max():.2e}")

    # Day-by-day operational loop over the last 30 days.
    state = state0
    q30 = []
    warm_start = T - 30
    q_head, _, _, state = run_gr4j_warm(prec[:warm_start],
                                        etp[:warm_start], state, params,
                                        num_uh1=3, num_uh2=7)
    for t in range(warm_start, T):
        q, _, _, state = run_gr4j_warm(prec[t:t + 1], etp[t:t + 1],
                                       state, params, num_uh1=3,
                                       num_uh2=7)
        q30.append(float(q[0]))
    diff = np.abs(np.asarray(q30) - np.asarray(q_full[warm_start:])).max()
    print(f"day-by-day loop (30 single-step continuations): "
          f"max |dq| vs unbroken = {diff:.2e}")

    # ------------------------------------------------------------------
    # The same workflow through the class API: simulate returns an opaque
    # state bundle and accepts it back -- including for the snow
    # compositions, whose bundles also carry the original series'
    # data-dependent snow-cover constants.
    # ------------------------------------------------------------------
    from rrmpg_jax.models import GR4J, CemaneigeGR4J

    model = GR4J(params=params)
    np_prec, np_etp = np.asarray(prec), np.asarray(etp)
    q_ref = model.simulate(np_prec, np_etp, s_init=0.4, r_init=0.6)
    q_hist, state = model.simulate(np_prec[:700], np_etp[:700],
                                   s_init=0.4, r_init=0.6,
                                   return_final_state=True)
    q_fc = model.simulate(np_prec[700:], np_etp[700:],
                          initial_state=state)
    d = np.abs(np.concatenate([q_hist, q_fc]) - q_ref).max()
    print(f"class API (GR4J): history + forecast vs unbroken: "
          f"max |dq| = {d:.2e}")

    snow = CemaneigeGR4J()
    mean_t = rng.uniform(-10, 15, T)
    kw = dict(met_station_height=495, altitudes=[550, 620, 700, 785, 920])
    margs = (np.asarray(rng.uniform(0, 15, T)), mean_t,
             mean_t - rng.uniform(0, 5, T), mean_t + rng.uniform(0, 5, T),
             np.asarray(rng.uniform(0, 4, T)))
    _, st = snow.simulate(*(a[:700] for a in margs),
                          return_final_state=True, **kw)
    q_one = snow.simulate(*(a[700:] for a in margs), initial_state=st,
                          **kw)
    q_h1, st_mid = snow.simulate(*(a[700:850] for a in margs),
                                 initial_state=st,
                                 return_final_state=True, **kw)
    q_h2 = snow.simulate(*(a[850:] for a in margs), initial_state=st_mid,
                         **kw)
    d = np.abs(np.concatenate([q_h1, q_h2]) - q_one).max()
    print(f"class API (CemaneigeGR4J): chained snow forecast segments: "
          f"max |dq| = {d:.2e}")

    # ------------------------------------------------------------------
    # Operational recalibration: fit the parameters on a recent segment
    # from the carried state (a cold-start fit of the same segment is
    # structurally wrong -- its zero-history assumption biases routing).
    # ------------------------------------------------------------------
    q_seg = np.asarray(q_ref)[700:, 0]
    warm_fit = model.fit(q_seg, np_prec[700:], np_etp[700:],
                         initial_state=state, seed=0, maxiter=40)
    cold_fit = model.fit(q_seg, np_prec[700:], np_etp[700:], seed=0,
                         maxiter=40)
    print(f"recalibration on the last 300 days: warm-fit MSE "
          f"{warm_fit.fun:.2e} vs cold-start {cold_fit.fun:.2e}")


if __name__ == "__main__":
    main()
