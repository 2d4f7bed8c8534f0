"""Benchmark harness: one JSON line on stdout, details on stderr.

Headline metric: the reference's own published speed benchmark -- the ABC
model over 10 million timesteps (``docs/source/examples/
speed_comparision.rst:199-263``: pure Python 5.83 s, numba 33.3 ms
~= 3.0e8 timesteps/s on one CPU core, Fortran 23.7 ms).  Three ``xla``
engines are timed -- the sequential scan, the parallel-prefix
``associative_scan`` and the hierarchical Toeplitz matmul scan
(``rrmpg_jax/ops/linear_scan.py``) -- and the fastest is reported;
``vs_baseline`` is its timesteps/s over the numba single-core baseline.

Secondary numbers (stderr): the fused ensemble objectives at 131,072
members x 3,651 days (GR4J, CemaneigeHystGR4JIce over 5 layers, HBV-Edu)
and the regional GR4J objective at 8 catchments.

Every time is warm, ends in ``block_until_ready``, and is the median of
several runs.  The run needs a GPU: without one it exits non-zero, and
any failed measurement fails the run.

    python bench.py             # one card
    python bench.py --scaling   # benchmarks/scaling.py
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

NUMBA_BASELINE_STEPS_PER_S = 10_000_000 / 33.3e-3  # 3.0e8, 1 CPU core
ROOT = os.path.dirname(os.path.abspath(__file__))
RUNS = 7


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def median_time(fn, *args, runs=RUNS):
    """Median warm seconds of ``fn(*args)`` (first call compiles)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def bench_abc_10m():
    """(timesteps/s, seconds, engine) of the fastest 10M-step ABC engine."""
    import jax
    import jax.numpy as jnp

    from rrmpg_jax.ops.abc import (run_abcmodel, run_abcmodel_matscan,
                                   run_abcmodel_pscan)

    T = 10_000_000
    prec = jnp.asarray(np.random.default_rng(0).uniform(0, 20, T),
                       jnp.float32)
    params = {'a': 0.3, 'b': 0.2, 'c': 0.15}
    results = {}
    for name, run in (("scan", run_abcmodel),
                      ("associative_scan", run_abcmodel_pscan),
                      ("matscan", run_abcmodel_matscan)):
        fn = jax.jit(lambda p, run=run: run(p, 0.0, params))
        results[name] = median_time(fn, prec)
        log(f"ABC 10M steps [{name}]: {results[name] * 1e3:.3f} ms "
            f"({T / results[name]:.3e} steps/s)")
    name, dt = min(results.items(), key=lambda kv: kv[1])
    return T / dt, dt, name


def _uniform(rng, bounds, n):
    import jax.numpy as jnp

    return {k: jnp.asarray(rng.uniform(lo, hi, n), jnp.float32)
            for k, (lo, hi) in bounds.items()}


def bench_fused(num_params=131072, T=3651, C=8, layers=5):
    """Median seconds of each fused objective at full width."""
    import jax.numpy as jnp

    from rrmpg_jax.ops.pallas_gr4j import (gr4j_ensemble_mse_pallas,
                                           gr4j_regional_mse_pallas)
    from rrmpg_jax.ops.pallas_hbv import hbv_ensemble_mse_pallas
    from rrmpg_jax.ops.pallas_snow import snowgr4j_ensemble_mse_pallas

    rng = np.random.default_rng(1)
    f = lambda a: jnp.asarray(a, jnp.float32)
    prec, etp, qobs = (f(rng.uniform(lo, hi, T))
                       for lo, hi in ((0, 15), (0, 4), (0, 5)))
    gr4j = _uniform(rng, {'x1': (100, 1200), 'x2': (-5, 3),
                          'x3': (20, 300), 'x4': (1.1, 2.9)}, num_params)
    snow = dict(gr4j, **_uniform(rng, {
        'CTG': (0, 1), 'Kf': (0, 6), 'Thacc': (5, 50), 'Rsp': (0.1, 1),
        'DDF': (1, 10)}, num_params))
    hbv = _uniform(rng, {
        'T_t': (-2, 2), 'DD': (0.5, 5), 'FC': (50, 500), 'Beta': (1, 6),
        'C': (0.01, 0.1), 'PWP': (30, 300), 'K_0': (0.1, 0.8),
        'K_1': (0.05, 0.4), 'K_2': (0.01, 0.2), 'K_p': (0.01, 0.1),
        'L': (1, 10)}, num_params)
    temp = f(rng.uniform(-10, 20, T))
    prec_l = f(rng.uniform(0, 15, (T, layers)))
    temp_l = f(rng.uniform(-10, 15, (T, layers)))
    fsol_l = f(rng.uniform(0, 1, (T, layers)))
    frac_ice = f(rng.uniform(0, 0.5, layers))
    month = jnp.asarray(rng.integers(0, 12, T))
    pe_m, t_m = f(rng.uniform(1, 4, 12)), f(rng.uniform(-5, 15, 12))
    scale = f(np.linspace(0.8, 1.2, C))[:, None]

    cases = {
        "GR4J": lambda: gr4j_ensemble_mse_pallas(
            prec, etp, qobs, 0.3, 0.3, gr4j, num_uh1=3, num_uh2=7),
        "CemaneigeHystGR4JIce": lambda: snowgr4j_ensemble_mse_pallas(
            prec_l, temp_l, etp, fsol_l, qobs, 0.0, 0.0, 0.3, 0.3, snow,
            frac_ice=frac_ice, hyst=True, ice=True, num_uh1=3, num_uh2=7),
        "HBVEdu": lambda: hbv_ensemble_mse_pallas(
            temp, prec, month, pe_m, t_m, qobs, 2.0, 100.0, 5.0, 5.0,
            hbv),
        f"GR4J regional {C} catchments": lambda: gr4j_regional_mse_pallas(
            prec[None] * scale, jnp.broadcast_to(etp, (C, T)),
            jnp.broadcast_to(qobs, (C, T)), 0.3, 0.3, gr4j, num_uh1=3,
            num_uh2=7),
    }
    out = {}
    for name, fn in cases.items():
        out[name] = median_time(fn)
        log(f"{name} fused objective, {num_params} members x {T} days: "
            f"{out[name] * 1e3:.3f} ms")
    return out


def main():
    import jax

    if "--scaling" in sys.argv:
        # Delegate to the scaling-efficiency harness (MC + DE throughput
        # at 1/2/4/... devices; see benchmarks/scaling.py).
        sys.argv.remove("--scaling")
        from benchmarks.scaling import main as scaling_main
        scaling_main()
        return 0

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"no GPU found (platform {devs[0].platform}); bench.py "
            "measures the card only")
        return 2
    from rrmpg_jax.config import enable_compile_cache

    enable_compile_cache(os.path.join(ROOT, ".jax_cache"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}")

    steps_per_s, dt, engine = bench_abc_10m()
    log(f"ABC 10M steps best [{engine}]: {dt * 1e3:.3f} ms")
    bench_fused()

    print(json.dumps({
        "metric": "ABC-model 10M-timestep throughput (reference headline "
                  "benchmark, speed_comparision.rst)",
        "value": round(steps_per_s, 1),
        "unit": "timesteps/s",
        "engine": engine,
        "vs_baseline": round(steps_per_s / NUMBA_BASELINE_STEPS_PER_S, 3),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
