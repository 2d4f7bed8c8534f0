"""Large-scale sharded ensembles: the batched workloads.

Demonstrates what has no counterpart in the reference package:

* a Monte-Carlo sweep sharded over every available device,
* device-side parameter sampling (no host round-trips),
* a fused-kernel calibration with checkpoint/resume,
* regional mode: a parameter ensemble crossed with many catchments.

Runs on any device count -- a CPU with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` behaves like an
8-device host; on several GPUs the same code shards over the cards.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from rrmpg_jax.models import GR4J
from rrmpg_jax.ops import run_gr4j
from rrmpg_jax.parallel import (
    default_mesh,
    ensemble_catchment_mesh,
    ensemble_objective,
    regional_run,
)


FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def main():
    print(f"devices: {jax.devices()}")
    mesh = default_mesh()
    rng = np.random.default_rng(0)

    T = 731 if FAST else 3651
    prec = rng.uniform(0, 15, T)
    etp = rng.uniform(0, 4, T)
    truth = {'x1': 320.0, 'x2': 1.2, 'x3': 80.0, 'x4': 2.1}
    qobs = np.asarray(run_gr4j(prec, etp, 0.3, 0.3, truth)[0])

    # --- sharded Monte Carlo with device-side sampling ---
    model = GR4J()
    n = 4096 if FAST else 65_536
    params = model.sample_params(jax.random.PRNGKey(0), n)
    losses, best_idx, best_loss = ensemble_objective(
        run_gr4j, (prec, etp, 0.3, 0.3), params, qobs, mesh)
    best = {k: float(v[best_idx]) for k, v in params.items()}
    print(f"MC {n} members: best MSE {float(best_loss):.4f} at "
          f"{ {k: round(v, 1) for k, v in best.items()} }")

    # --- fused-kernel calibration with checkpointing ---
    ckpt = "/tmp/gr4j_fit.npz"
    engine = "pallas" if jax.devices()[0].platform == "gpu" else "xla"
    res = model.fit(qobs, prec, etp, seed=0, engine=engine, tol=1e-4,
                    maxiter=10 if FAST else 1000,
                    checkpoint_path=ckpt, checkpoint_every=25)
    print(f"DE ({engine}): fun={res.fun:.2e} nit={res.nit} "
          f"x={np.round(res.x, 2)}  (checkpointed to {ckpt})")
    os.path.exists(ckpt) and os.unlink(ckpt)

    # --- regional mode: ensemble x catchments on a 2-D mesh ---
    n_dev = len(jax.devices())
    mesh2 = ensemble_catchment_mesh(ensemble=max(n_dev // 2, 1),
                                    catchment=2 if n_dev > 1 else 1)
    C, N = (4, 128) if FAST else (8, 512)
    precs = rng.uniform(0, 15, (C, T))
    etps = rng.uniform(0, 4, (C, T))
    ens = model.sample_params(jax.random.PRNGKey(1), N)
    qsim, _, _ = regional_run(
        lambda p, e, pa: run_gr4j(p, e, 0.2, 0.2, pa), (precs, etps),
        ens, mesh=mesh2)
    print(f"regional: {C} catchments x {N} members -> qsim {qsim.shape}")


if __name__ == "__main__":
    main()
