# This file is part of rrmpg-jax, a rainfall-runoff modeling framework for
# accelerators (JAX / XLA / Pallas).
#
# rrmpg-jax provides the full capability surface of the reference RRMPG
# package (conceptual hydrological models, Monte-Carlo ensembles, global
# calibration, evaluation metrics, CAMELS toy data), re-designed for accelerators:
# the per-timestep storage-update recurrences are `jax.lax.scan` /
# `jax.lax.associative_scan` kernels, parameter ensembles and catchments are
# batch axes handled by `jax.vmap`, and large ensembles shard over a
# `jax.sharding.Mesh` with GSPMD-compiled collectives.
#
# Licensed under the MIT License.

__version__ = "0.5.0"
__author__ = "rrmpg-jax developers"

from . import data
from . import models
from . import ops
from . import parallel
from . import tools
from . import utils
