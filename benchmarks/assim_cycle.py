"""Assimilation-cycling throughput: host loop vs device-resident scan.

Operational forecasting cycles forecast/analysis once per window -- at
daily cycling over decades that is thousands of cycles.  The host
backend of :func:`rrmpg_jax.tools.assimilation.assimilation_cycle`
re-enters ``model.simulate`` per window (validation + numpy round-trips
+ a fresh device launch each cycle: dispatch-bound), while
``backend='scan'`` folds the whole loop into ONE ``lax.scan`` program.
This benchmark times both on the same GR4J twin setup and reports
cycles/s and the speedup (target: scan >= 5x host at 100+ windows; not
measured on a GPU yet).

Timing notes: the scan variant is compiled once and timed over repeated
full-loop invocations, each ending in ``block_until_ready``; the host
loop is timed once (it is seconds-slow).

Run: ``python benchmarks/assim_cycle.py`` (add ``--windows N``,
``--members N``).  Prints one JSON line per backend.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=128)
    ap.add_argument("--members", type=int, default=1024)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--method", choices=("enkf", "pf"), default="enkf")
    args = ap.parse_args()

    import jax

    from rrmpg_jax.models import GR4J
    from rrmpg_jax.tools.assimilation import (
        assimilation_cycle,
        perturb_state,
    )

    n_cycles, n, w = args.windows, args.members, args.window
    T = (n_cycles + 1) * w
    rng = np.random.default_rng(42)
    prec = rng.gamma(0.8, 6.0, T)
    etp = rng.uniform(1, 4, T)
    truth = {'x1': 320.0, 'x2': 1.0, 'x3': 90.0, 'x4': 1.7}
    model = GR4J(params=truth)
    q_true = np.asarray(model.simulate(prec, etp, s_init=0.9,
                                       r_init=0.7))[:, 0]
    obs = q_true + rng.normal(0, 0.02, T)
    params_ens = {k: np.full(n, v) for k, v in truth.items()}
    _, st0 = model.simulate(prec[:w], etp[:w], params=params_ens,
                            return_final_state=True)
    st0 = perturb_state(st0, jax.random.PRNGKey(7), rel_std=0.3)
    f = {'prec': prec[w:], 'etp': etp[w:]}
    common = dict(obs_std=0.02, params=params_ens, seed=0,
                  method=args.method)
    if args.method == "pf":
        common.update(ess_threshold=0.7, jitter=0.1)

    results = {}
    # --- scan backend: compile, then time re-perturbed repeats ---
    assimilation_cycle(model, f, obs[w:], w, initial_state=st0,
                       backend="scan", **common)  # compile
    t = np.inf
    for r in range(args.repeats):
        st_r = perturb_state(st0, jax.random.PRNGKey(100 + r),
                             rel_std=0.3)
        jax.block_until_ready(jax.tree.leaves(st_r))
        t0 = time.perf_counter()
        state, _, qsim, _ = assimilation_cycle(
            model, f, obs[w:], w, initial_state=st_r, backend="scan",
            **common)
        t = min(t, time.perf_counter() - t0)
    assert np.isfinite(qsim).all()
    results["scan"] = t

    # --- host backend: one timed pass (seconds-slow by construction) ---
    st_r = perturb_state(st0, jax.random.PRNGKey(200), rel_std=0.3)
    t0 = time.perf_counter()
    state, _, qsim_h, _ = assimilation_cycle(
        model, f, obs[w:], w, initial_state=st_r, backend="host",
        **common)
    results["host"] = time.perf_counter() - t0
    assert np.isfinite(qsim_h).all()

    speedup = results["host"] / results["scan"]
    for backend in ("host", "scan"):
        print(json.dumps({
            "metric": f"assim_cycle_{args.method}_{backend}",
            "value": round(n_cycles / results[backend], 2),
            "unit": "cycles/s",
            "windows": n_cycles, "members": n, "window": w,
            "wall_s": round(results[backend], 3),
            "speedup_scan_vs_host": round(speedup, 2),
        }))
    return speedup


if __name__ == "__main__":
    main()
