"""Ensemble data assimilation: EnKF state updating for forecasts.

No reference counterpart -- the reference cannot even resume a
simulation, let alone correct its states against observations.  This
twin experiment shows the full operational loop on CAMELS forcing:
truth run -> biased ensemble -> forecast/analysis cycling with the
stochastic EnKF (rrmpg_jax.tools.assimilation) -> forecast errors.

Captured output::

    ensemble: 256 members, biased-dry start (truth s=0.85, ensemble 0.2)
    free-run  forecast RMSE (day 48-240): 1.0521
    EnKF      forecast RMSE (day 48-240): 0.0036
    innovation |obs - forecast mean| first 3 cycles: 0.755, last 3: 0.009
    analysis production store mean: 168.6 mm (truth trajectory 168.6 mm)

Reading: cycling the filter cuts the forecast error by ~300x against
the free-running biased ensemble, and the analysis recovers the truth's
(unobserved) production store to the tenth of a millimetre from
discharge observations alone.
"""

import numpy as np


def main():
    import jax

    from rrmpg_jax.data import CAMELSLoader
    from rrmpg_jax.models import GR4J
    from rrmpg_jax.tools import assimilation_cycle, perturb_state

    df = CAMELSLoader().load_basin('01031500')
    T, window = 252, 12
    prec = df['prcp(mm/day)'].values[:T]
    etp = df['PET'].values[:T]

    truth_params = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
    model = GR4J(params=truth_params)

    # Truth: wet initial stores; observations = truth + sensor noise.
    q_true = np.asarray(model.simulate(prec, etp, s_init=0.85,
                                       r_init=0.7))[:, 0]
    rng = np.random.default_rng(0)
    obs = q_true + rng.normal(0, 0.02, T)

    # Ensemble: same parameters (pure state estimation), biased-dry
    # start, spread from mean-preserving lognormal perturbations.
    n = 256
    params_ens = {k: np.full(n, v) for k, v in truth_params.items()}
    _, state0 = model.simulate(prec[:window], etp[:window], s_init=0.2,
                               r_init=0.2, params=params_ens,
                               return_final_state=True)
    state0 = perturb_state(state0, jax.random.PRNGKey(7), rel_std=0.4)
    print(f"ensemble: {n} members, biased-dry start "
          f"(truth s=0.85, ensemble 0.2)")

    # Free run: no assimilation.
    q_free = np.asarray(model.simulate(prec[window:], etp[window:],
                                       params=params_ens,
                                       initial_state=state0))

    # Forecast/analysis cycling: each 12-day window runs from the last
    # analysis and assimilates the window-end observation.
    state, _, q_prior, diags = assimilation_cycle(
        model, {'prec': prec[window:], 'etp': etp[window:]},
        obs[window:], window, obs_std=0.05, params=params_ens, seed=0,
        initial_state=state0)

    t0 = 4 * window  # skip the spin-up cycles
    truth_tail = q_true[window:]

    def rmse(q):
        d = q[t0:].mean(axis=1) - truth_tail[t0:len(q)]
        return float(np.sqrt(np.mean(d ** 2)))

    print(f"free-run  forecast RMSE (day {t0}-{len(q_free)}): "
          f"{rmse(q_free):.4f}")
    print(f"EnKF      forecast RMSE (day {t0}-{len(q_prior)}): "
          f"{rmse(q_prior):.4f}")
    inn = np.abs(diags.innovation[:, 0])
    print(f"innovation |obs - forecast mean| first 3 cycles: "
          f"{inn[:3].mean():.3f}, last 3: {inn[-3:].mean():.3f}")

    # The analysis states themselves: the filter recovered the truth's
    # production store from discharge observations alone.
    s_analysis = float(np.asarray(state.s).mean())
    q_t, st_t = model.simulate(prec, etp, s_init=0.85, r_init=0.7,
                               return_final_state=True)
    s_truth = float(np.asarray(st_t.s)[0])
    print(f"analysis production store mean: {s_analysis:.1f} mm "
          f"(truth trajectory {s_truth:.1f} mm)")


if __name__ == "__main__":
    main()
