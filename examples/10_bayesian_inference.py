"""Bayesian parameter inference on a real basin (DE-MC posterior).

GLUE (example 05) weights a Monte-Carlo ensemble informally; this
example runs formal MCMC instead: DE-MC (``rrmpg_jax.tools.demc_sample``,
the DREAM-family algorithm) samples the joint posterior of GR4J's four
parameters *and* an unknown observation-noise scale on five years of
CAMELS basin 01031500, giving calibrated credible intervals.  All
chains step together as one batched device evaluation and the entire
sampler is a single jitted scan, so more chains widen one batched
program rather than adding steps.

Captured output::

    acceptance 0.24, max R-hat 1.007 (128 chains x 8000 steps)
    posterior (median [2.5%, 97.5%]):
      x1    445.4 [382.2, 513.3]
      x2    0.864 [0.638, 1.096]
      x3    31.98 [25.93, 38.5]
      x4    1.119 [1.101, 1.161]
      sigma 2.561 [2.48, 2.645]

Reading: x4's razor-thin interval says the routing time base is pinned
by five years of data; the posterior sigma^2 ~ 6.56 agrees with the DE
fit's MSE 6.53 on the same period (example 07) -- the residual scale
IS the model error, now with calibrated uncertainty around every
parameter instead of one point estimate.  Chain-count note: 16 chains
had not converged at 6000 steps (R-hat 2.6); 128 chains converge
cleanly.
"""

import os

import numpy as np

FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def main():
    import time

    import jax.numpy as jnp

    from rrmpg_jax.data import CAMELSLoader
    from rrmpg_jax.models import GR4J
    from rrmpg_jax.ops import run_gr4j
    from rrmpg_jax.tools import demc_sample

    df = CAMELSLoader().load_basin('01031500')
    T = 365 if FAST else 1825
    prec = jnp.asarray(df['prcp(mm/day)'].values[:T])
    etp = jnp.asarray(df['PET'].values[:T])
    qobs = jnp.asarray(df['QObs(mm/d)'].values[:T])

    model = GR4J()
    names = list(model._param_list) + ['sigma']
    bounds = [model._default_bounds[p] for p in model._param_list]
    bounds.append((0.05, 5.0))  # observation-noise scale, sampled too

    def log_prob(x):
        params = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
        sigma = x[4]
        qsim, _, _ = run_gr4j(prec, etp, 0.0, 0.0, params)
        # Gaussian likelihood with unknown sigma (Jeffreys-ish via the
        # explicit -T log sigma term).
        sse = jnp.sum((qobs - qsim) ** 2)
        return -0.5 * sse / sigma ** 2 - T * jnp.log(sigma)

    chains, steps = (32, 400) if FAST else (128, 8000)
    t0 = time.time()
    res = demc_sample(log_prob, bounds, num_chains=chains,
                      num_steps=steps, burn_in=0.6, seed=0)
    wall = time.time() - t0
    print(f"acceptance {res.acceptance_rate:.2f}, max R-hat "
          f"{np.nanmax(res.r_hat):.3f} ({chains} chains x {steps} steps, "
          f"{wall:.0f} s)")

    flat = res.flat()
    lo, med, hi = np.percentile(flat, [2.5, 50, 97.5], axis=0)
    print("posterior (median [2.5%, 97.5%]):")
    for i, name in enumerate(names):
        print(f"  {name:<5s} {med[i]:.4g} [{lo[i]:.4g}, {hi[i]:.4g}]")



if __name__ == "__main__":
    main()
