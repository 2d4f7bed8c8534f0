"""Device-mesh helpers for sharded ensemble execution.

The framework's parallel axes are *ensemble* (parameter sets; the
data-parallel analog) and *catchment* (regional runs).  Both are
embarrassingly parallel: sharding the leading batch axis with a
``NamedSharding`` lets GSPMD partition every kernel without any manual
collectives; reductions (ensemble argmin/mean in calibration) compile to
``psum``-style collectives, which XLA hands to NCCL on GPUs.

The reference has no distributed machinery at all (single process, serial
loops -- see SURVEY.md section 2.5); this module is its replacement.
The meshes are plain reshapes of the device list: every card of a host
reaches every other at the same rate, so no topology-shaped layout is
wanted.  For multi-host runs call :func:`jax.distributed.initialize`
before building the mesh.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENSEMBLE_AXIS = "ensemble"
CATCHMENT_AXIS = "catchment"


def default_mesh(devices=None, axis_name=ENSEMBLE_AXIS):
    """A 1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def ensemble_catchment_mesh(ensemble=None, catchment=1, devices=None):
    """A 2-D (ensemble, catchment) mesh.

    Args:
        ensemble: size of the ensemble axis (defaults to
            ``num_devices // catchment``).
        catchment: size of the catchment axis.
        devices: devices to use (defaults to all).
    """
    if devices is None:
        devices = jax.devices()
    if ensemble is None:
        ensemble = len(devices) // catchment
    devices = np.asarray(devices[:ensemble * catchment]).reshape(
        ensemble, catchment)
    return Mesh(devices, (ENSEMBLE_AXIS, CATCHMENT_AXIS))


def shard_leading_axis(tree, mesh, axis_name=ENSEMBLE_AXIS):
    """Place every leaf of ``tree`` with its leading axis sharded on mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def replicate(tree, mesh):
    """Place every leaf of ``tree`` replicated across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def relaxed_shard_map(f, mesh, in_specs, out_specs):
    """``jax.shard_map`` with varying-axes checking off.

    The regional objectives start their scan carries varying only over
    the ensemble axis and widen to the catchment axis when forcings
    enter -- benign, but rejected by the strict checker.
    """
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)
