"""Pure-functional JAX model kernels (the framework's "native" layer).

Every ``run_*`` function simulates a single parameter set; ensembles are
obtained with :func:`jax.vmap` over the ``params`` dict (see
:mod:`rrmpg_jax.parallel.ensemble` for sharded variants).
"""

from .abc import (run_abcmodel, run_abcmodel_matscan, run_abcmodel_pscan,
                  run_abcmodel_warm)
from .linear_scan import linear_recurrence
from .cemaneige import (
    run_cemaneige,
    run_cemaneige_warm,
    run_cemaneigehyst,
    run_cemaneigehyst_warm,
    run_icemelt,
)
from .compositions import (
    run_cemaneigegr4j,
    run_cemaneigegr4j_warm,
    run_cemaneigegr4jice,
    run_cemaneigehystgr4j,
    run_cemaneigehystgr4j_warm,
    run_cemaneigehystgr4jice,
)
from .gr4j import (GR4JState, gr4j_initial_state, run_gr4j,
                   run_gr4j_warm)
from .pallas_gr4j import (
    gr4j_ensemble_mse_pallas,
    gr4j_regional_mse_pallas,
    gr4j_simulate_pallas,
)
from .pallas_hbv import hbv_ensemble_mse_pallas, hbv_simulate_pallas
from .pallas_snow import (
    cemaneige_ensemble_mse_pallas,
    cemaneige_simulate_pallas,
    losses_from_stats,
    q_sca_loss_from_stats,
    snowgr4j_ensemble_mse_pallas,
    snowgr4j_regional_mse_pallas,
    snowgr4j_simulate_pallas,
)
from .hbvedu import run_hbvedu, run_hbvedu_warm
from .met import (
    calculate_solid_fraction,
    extrapolate_precipitation,
    extrapolate_temperature,
)
from .uh import NUM_UH1, NUM_UH2, causal_fir, uh_ordinates
