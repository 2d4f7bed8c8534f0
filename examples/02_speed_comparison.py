"""The reference's headline speed benchmark on an accelerator.

The reference compares pure Python (5.83 s), numba (33.3 ms) and Fortran
(23.7 ms) on 10M ABC-model timesteps
(``docs/source/examples/speed_comparision.rst``).  Here the same
simulation runs on the three ``xla`` engines -- the sequential scan, the
parallel-prefix ``associative_scan`` and the Toeplitz-matmul linear scan
-- and as a batched ensemble, which is where an accelerator actually
earns its keep.  Times are warm, end in ``block_until_ready`` and are
the best of three runs.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from rrmpg_jax.ops import (run_abcmodel, run_abcmodel_matscan,
                           run_abcmodel_pscan)
from rrmpg_jax.utils.profiling import benchmark

NUMBA_MS = 33.3

# CI fast mode (tests/test_examples.py): tiny sizes so the example
# executes end-to-end in seconds; the benchmark sizes are the defaults.
FAST = os.environ.get("RRMPG_EXAMPLE_FAST") == "1"


def timed(kernel, prec, params):
    """(compile seconds, best-of-3 warm seconds) of one simulation."""
    fn = jax.jit(lambda p: kernel(p, 0.0, params))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(prec))
    compile_s = time.perf_counter() - t0
    best = float('inf')
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(prec))
        best = min(best, time.perf_counter() - t0)
    return compile_s, best


def main():
    T = 500_000 if FAST else 10_000_000
    rng = np.random.default_rng(0)
    prec = jnp.asarray(rng.uniform(0, 20, T), jnp.float32)
    params = {'a': jnp.float32(0.3), 'b': jnp.float32(0.2),
              'c': jnp.float32(0.15)}
    engines = {"sequential scan": run_abcmodel,
               "associative_scan": run_abcmodel_pscan,
               "Toeplitz matscan": run_abcmodel_matscan}
    for name, kernel in engines.items():
        compile_s, per = timed(kernel, prec, params)
        print(f"ABC {T} steps [{name}]: compile {compile_s:.1f}s, "
              f"{per * 1e3:.3f} ms/sim = {T / per:.3e} steps/s "
              f"({NUMBA_MS * T / 10_000_000 / (per * 1e3):.1f}x numba)")

    # Ensemble version: 1024 parameter sets over 1M steps each.
    N, T_e = (64, 50_000) if FAST else (1024, 1_000_000)
    prec_e = jnp.asarray(rng.uniform(0, 20, T_e), jnp.float32)
    batch = {k: jnp.asarray(rng.uniform(0.05, 0.45, N), jnp.float32)
             for k in ('a', 'b', 'c')}
    fn_e = jax.jit(jax.vmap(
        lambda p: run_abcmodel_matscan(prec_e, 0.0, p)[0]))
    res_e = benchmark(fn_e, batch, repeats=3)
    print(f"ABC ensemble {N}x{T_e}: best {res_e.best_s * 1e3:.1f} ms "
          f"({res_e.throughput(N * T_e):.3e} catchment-steps/s)")


if __name__ == "__main__":
    main()
