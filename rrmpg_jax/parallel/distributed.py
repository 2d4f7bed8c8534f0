"""Multi-host runtime initialization.

A thin convenience wrapper over :func:`jax.distributed.initialize` for
multi-host runs: call :func:`initialize` once per host process before
building meshes; every sharded path in the framework (ensemble, regional,
calibration) then spans all hosts' devices automatically -- GSPMD places
the collectives, and XLA hands them to the interconnect's library (NCCL
on GPUs).

Host-local data feeding for regional runs: build global arrays from
per-host shards with ``jax.make_array_from_process_local_data`` and the
mesh shardings from :mod:`rrmpg_jax.parallel.mesh`.
"""

import jax


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, **kwargs):
    """Initialize the multi-host JAX runtime (no-op if single-process).

    Args are forwarded to :func:`jax.distributed.initialize`.  Where no
    cluster manager announces the job, pass ``coordinator_address``
    (e.g. ``"localhost:<port>"``), ``num_processes`` and ``process_id``.

    Returns:
        (process_index, process_count, global_device_count)
    """
    if num_processes is None or num_processes > 1:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id,
                **kwargs)
        except (ValueError, RuntimeError) as exc:
            # Tolerate exactly two benign cases; genuine multi-host
            # misconfiguration (wrong coordinator address, missing peers)
            # must fail loudly, not silently degrade to single-process.
            msg = str(exc).lower()
            already = "should only be called once" in msg
            undetectable = num_processes is None and any(
                frag in msg for frag in
                ("coordinator_address should be defined",
                 "before any jax calls",
                 "auto-detect", "could not be detected", "not set"))
            if not (already or undetectable):
                raise
    return jax.process_index(), jax.process_count(), jax.device_count()
