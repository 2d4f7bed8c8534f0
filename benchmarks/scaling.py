"""Scaling-efficiency harness: MC + DE throughput vs device count.

Pins the scaling contract from BASELINE.md (">= 85% scaling efficiency at
2+ hosts"): the Monte-Carlo ensemble objective and one differential-
evolution generation are timed on meshes of 1/2/4/... devices with the
per-device workload held constant (weak scaling), and efficiency is
reported as ``throughput(n) / (n * throughput(1))``.

On several cards the target is >= 0.85 (not measured yet).  On the CPU
test configuration (``--xla_force_host_platform_device_count=N``)
all virtual devices share the host's physical cores, so efficiencies far
below 1 are EXPECTED there -- the CPU run validates that the sharded
programs compile, execute and partition correctly at every mesh size, not
the hardware contract itself.

Run: ``python benchmarks/scaling.py`` (add ``--devices 1,2,4,8``,
``--members-per-device N``).  Writes ``BENCH_scaling.json`` and prints one
JSON line per mesh size.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

# Allow `python benchmarks/scaling.py` from a source checkout.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gr4j_inputs(T=3651, seed=1):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    dtype = jnp.float32 if not jnp_x64() else jnp.float64
    prec = jnp.asarray(rng.uniform(0, 15, T), dtype)
    etp = jnp.asarray(rng.uniform(0, 4, T), dtype)
    qobs = jnp.asarray(rng.uniform(0, 5, T), dtype)
    return prec, etp, qobs


def jnp_x64():
    import jax
    return jax.config.read("jax_enable_x64")


def _sample_params(num, seed=2):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    dtype = jnp.float32 if not jnp_x64() else jnp.float64
    return {
        'x1': jnp.asarray(rng.uniform(100, 1200, num), dtype),
        'x2': jnp.asarray(rng.uniform(-5, 3, num), dtype),
        'x3': jnp.asarray(rng.uniform(20, 300, num), dtype),
        'x4': jnp.asarray(rng.uniform(1.1, 2.9, num), dtype),
    }


def bench_mc(mesh, members, repeats=4):
    """Weak-scaling MC: per-member GR4J MSE, members sharded over mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from rrmpg_jax.ops import run_gr4j

    prec, etp, qobs = _gr4j_inputs()
    params = _sample_params(members)
    sharding = NamedSharding(mesh, P("ensemble"))
    params = jax.tree.map(lambda x: jax.device_put(x, sharding), params)
    T = prec.shape[0]

    @jax.jit
    def mc_losses(params, seed):
        def member(p):
            qsim, _, _ = run_gr4j(prec, etp, 0.3, 0.3, p)
            return jnp.mean((qsim - qobs - seed * 1e-9) ** 2)
        losses = jax.vmap(member)(params)
        return losses[jnp.argmin(losses)]

    float(mc_losses(params, jnp.asarray(0., prec.dtype)))  # compile
    best = float('inf')
    for k in range(1, repeats):
        t0 = time.perf_counter()
        float(mc_losses(params, jnp.asarray(float(k), prec.dtype)))
        best = min(best, time.perf_counter() - t0)
    return members / best, members * T / best


def bench_de_generation(mesh, pop_per_device, generations=8, repeats=3):
    """Weak-scaling DE: generations of a GR4J calibration, population
    sharded over the mesh."""
    import jax.numpy as jnp

    from rrmpg_jax.tools.calibration import differential_evolution
    from rrmpg_jax.ops import run_gr4j

    prec, etp, qobs = _gr4j_inputs()
    n_dev = mesh.shape["ensemble"]
    popsize = max(1, (pop_per_device * n_dev) // 4)   # dim = 4
    bounds = [(100, 1200), (-5, 3), (20, 300), (1.1, 2.9)]

    def objective(x):
        p = {'x1': x[0], 'x2': x[1], 'x3': x[2], 'x4': x[3]}
        qsim, _, _ = run_gr4j(prec, etp, 0.3, 0.3, p)
        return jnp.mean((qsim - qobs) ** 2)

    best = float('inf')
    for k in range(repeats):
        t0 = time.perf_counter()
        differential_evolution(objective, bounds, seed=k, popsize=popsize,
                               maxiter=generations, tol=0.0, mesh=mesh)
        best = min(best, time.perf_counter() - t0)
    pop = popsize * 4
    return generations * pop / best, pop


def main():
    import jax
    from jax.sharding import Mesh

    parser = argparse.ArgumentParser()
    parser.add_argument("--devices", default=None,
                        help="comma-separated mesh sizes (default: powers "
                             "of two up to the available device count)")
    parser.add_argument("--members-per-device", type=int, default=4096)
    parser.add_argument("--pop-per-device", type=int, default=64)
    parser.add_argument("--out", default="BENCH_scaling.json")
    args = parser.parse_args()

    all_devices = jax.devices()
    if args.devices:
        sizes = [int(s) for s in args.devices.split(",")]
    else:
        sizes, n = [], 1
        while n <= len(all_devices):
            sizes.append(n)
            n *= 2
    platform = all_devices[0].platform

    rows = []
    base_mc = base_de = None
    for n in sizes:
        if n > len(all_devices):
            break
        mesh = Mesh(np.asarray(all_devices[:n]), ("ensemble",))
        mc_sets_s, mc_ct_s = bench_mc(mesh, args.members_per_device * n)
        de_evals_s, pop = bench_de_generation(mesh, args.pop_per_device)
        if n == 1:
            base_mc, base_de = mc_sets_s, de_evals_s
        row = {
            "devices": n, "platform": platform,
            "mc_param_sets_per_s": round(mc_sets_s, 1),
            "mc_catchment_timesteps_per_s": round(mc_ct_s, 1),
            "mc_efficiency": round(mc_sets_s / (n * base_mc), 4),
            "de_member_evals_per_s": round(de_evals_s, 1),
            "de_population": pop,
            "de_efficiency": round(de_evals_s / (n * base_de), 4),
        }
        rows.append(row)
        print(json.dumps(row))

    result = {
        "workload": "weak scaling: GR4J MC objective + DE generations, "
                    "population/ensemble axis sharded over the mesh",
        "members_per_device": args.members_per_device,
        "target": "efficiency >= 0.85 on real multi-card meshes "
                  "(BASELINE.md); CPU virtual devices share host cores "
                  "and are correctness-only",
        "rows": rows,
    }
    with open(args.out, "w") as fp:
        json.dump(result, fp, indent=1)
    print(f"[scaling] wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
