"""Cemaneige + degree-day ice melt + GR4J interface class.

API-compatible with the reference ``CemaneigeGR4JIce``
(``rrmpg/models/cemaneigegr4jice.py``): seven parameters (CTG, Kf, x1..x4,
DDF), glacier fractions per elevation layer, MSE-only calibration.
"""

import jax.numpy as jnp
import numpy as np

import functools

from ..ops.compositions import run_cemaneigegr4jice
from ..ops.uh import required_uh_lengths
from ..utils.array_checks import validate_array_input
from ._snow_base import CemaneigeBase
from .gr4j import GR4J


class CemaneigeGR4JIce(CemaneigeBase):
    """Interface to the Cemaneige + IceMelt + GR4J coupled model."""

    _param_list = ['CTG', 'Kf', 'x1', 'x2', 'x3', 'x4', 'DDF']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (1, 15),
                       'x1': (100, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 300),
                       'x4': (1.1, 2.9),
                       'DDF': (1, 30)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64),
                       ('x1', np.float64),
                       ('x2', np.float64),
                       ('x3', np.float64),
                       ('x4', np.float64),
                       ('DDF', np.float64)])

    def __init__(self, params=None):
        super().__init__(params=params)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _kernel_for(num_uh1, num_uh2):
        def kernel(prec, mean_temp, etp, frac_ice, frac_solid_prec,
                   snow_pack_init, thermal_state_init, s_init, r_init,
                   params):
            return run_cemaneigegr4jice(
                prec, mean_temp, etp, frac_ice, frac_solid_prec,
                snow_pack_init, thermal_state_init, s_init, r_init, params,
                num_uh1, num_uh2)
        return kernel

    def _prepare(self, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                 met_station_height, altitudes, snow_pack_init,
                 thermal_state_init, s_init, r_init):
        prec, mean_temp, frac_solid_prec, _, (etp,) = self._validate_met(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes, extra_series=(('pot. evapotranspiration', etp),))
        frac_ice = self._validate_frac_ice(frac_ice)
        snow_pack_init = self._validate_number(snow_pack_init,
                                               'snow_pack_init')
        thermal_state_init = self._validate_number(thermal_state_init,
                                                   'thermal_state_init')
        s_init, r_init = GR4J._validate_inits(s_init, r_init)
        return (prec, mean_temp, frac_solid_prec, etp, frac_ice,
                snow_pack_init, thermal_state_init, s_init, r_init)

    def simulate(self, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 s_init=0, r_init=0, altitudes=[], return_storage=False,
                 params=None, mesh=None, engine="xla", interpret=False,
                 initial_state=None, return_final_state=False):
        """Simulate the coupled snow + ice + runoff model.

        Args as :meth:`CemaneigeGR4J.simulate` (including
        ``initial_state`` / ``return_final_state`` forecast mode), plus
        ``frac_ice``: (L,) glaciated fraction of each elevation layer.

        Returns:
            qsim (T, N); plus (G, eTG, s_store, r_store, ice_melt) if
            ``return_storage`` (reference order,
            ``cemaneigegr4jice.py:285-288``); plus the final
            :class:`~rrmpg_jax.models.states.SnowGR4JState` if
            ``return_final_state``.
        """
        (prec, mean_temp, frac_solid_prec, etp, frac_ice, snow_pack_init,
         thermal_state_init, s_init, r_init) = self._prepare(
            prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, altitudes, snow_pack_init,
            thermal_state_init, s_init, r_init)
        inits = (snow_pack_init, thermal_state_init, s_init, r_init)
        self._check_no_cold_inits(
            initial_state, inits,
            ('snow_pack_init', 'thermal_state_init', 's_init', 'r_init'))

        param_dict, _ = self._prepare_params(params)
        if initial_state is not None or return_final_state:
            self._check_stateful_engine(engine, mesh, return_storage)
            n1, n2 = required_uh_lengths(param_dict['x4'])
            return self._simulate_stateful(
                hyst=False, ice=True, num_uh1=n1, num_uh2=n2,
                param_dict=param_dict, initial_state=initial_state,
                return_final_state=return_final_state,
                return_storage=return_storage, prec=prec,
                mean_temp=mean_temp, etp=etp,
                frac_solid_prec=frac_solid_prec, inits=inits,
                frac_ice=frac_ice, mesh=mesh, engine=engine, interpret=interpret)
        if engine == "pallas":
            if mesh is not None:
                raise ValueError(
                    "engine='pallas' simulate runs single-device through "
                    "the class API and would silently ignore mesh; use "
                    "engine='xla' for sharded simulation, or the "
                    "regional/ensemble helpers in rrmpg_jax.parallel.")
            if return_storage:
                raise ValueError(
                    "engine='pallas' computes discharge only; use "
                    "engine='xla' for storage trajectories.")
            return self._pallas_simulate(
                param_dict, prec, mean_temp, etp, frac_solid_prec,
                snow_pack_init, thermal_state_init, s_init, r_init,
                frac_ice=frac_ice, ice=True, interpret=interpret)
        if engine != "xla":
            raise ValueError("engine must be 'xla' or 'pallas'.")
        n1, n2 = required_uh_lengths(param_dict['x4'])
        qsim, G, eTG, s_store, r_store, ice_melt = self._run_batched(
            self._kernel_for(n1, n2),
            (prec, mean_temp, etp, frac_ice, frac_solid_prec,
             snow_pack_init, thermal_state_init, s_init, r_init),
            param_dict, mesh=mesh)
        if return_storage:
            return qsim, G, eTG, s_store, r_store, ice_melt
        return qsim

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """Device-resident cycling pieces (see CemaneigeBase)."""
        return self._warm_cycle_pieces_snow(forcings, sim_kwargs,
                                            hyst=False, ice=True)

    def _fused_stats(self, qobs, param_dict, sim_kwargs):
        """Trajectory-free sufficient statistics for
        ``monte_carlo(return_qsim=False, engine='pallas')``
        (see :meth:`CemaneigeBase._fused_stats_family`)."""
        return self._fused_stats_family(qobs, param_dict,
                                        sim_kwargs, hyst=False,
                                        ice=True)

    def fit(self, obs, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, snow_pack_init=0, thermal_state_init=0,
            s_init=0, r_init=0, altitudes=[], loss_metric="mse", seed=None,
            engine="xla", interpret=False, initial_state=None,
            **de_kwargs):
        """Calibrate on observed discharge with MSE loss (device DE).

        Args:
            loss_metric: calibration loss -- 'mse' (default),
                'rmse', or 'nse'/'kge' minimizing ``1 - score``
                (both engines; the fused kernel computes the efficiency
                scores from on-device sufficient statistics).
            engine: 'xla', or 'pallas' for the fused ensemble kernel.
            initial_state: (optional) single-member
                :class:`~rrmpg_jax.models.states.SnowGR4JState` --
                calibrate a continuation segment from a known initial
                condition (``engine='xla'`` only).

        Returns:
            An :class:`~rrmpg_jax.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize
        from ..utils.metrics import calibration_loss

        loss = calibration_loss(loss_metric)
        obs = validate_array_input(obs, np.float64, 'obs')
        (prec, mean_temp, frac_solid_prec, etp, frac_ice, snow_pack_init,
         thermal_state_init, s_init, r_init) = self._prepare(
            prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, altitudes, snow_pack_init,
            thermal_state_init, s_init, r_init)
        self._check_no_cold_inits(
            initial_state,
            (snow_pack_init, thermal_state_init, s_init, r_init),
            ('snow_pack_init', 'thermal_state_init', 's_init', 'r_init'))

        bounds = tuple(self._default_bounds[p] for p in self._param_list)

        if initial_state is not None:
            return self._warm_fit_de(
                hyst=False, ice=True, engine=engine,
                initial_state=initial_state, prec=prec,
                mean_temp=mean_temp, etp=etp,
                frac_solid_prec=frac_solid_prec, obs=obs, loss=loss,
                seed=seed, de_kwargs=de_kwargs, frac_ice=frac_ice,
                loss_metric=loss_metric, interpret=interpret)

        if engine == "pallas":
            batch_objective = self._pallas_batch_objective(
                loss_metric, prec, mean_temp, etp, frac_solid_prec, obs,
                snow_pack_init, thermal_state_init, s_init, r_init,
                frac_ice=frac_ice, ice=True, interpret=interpret)
            return minimize(batch_objective, bounds,
                                          seed=seed, batched=True,
                                          **de_kwargs)
        if engine != "xla":
            raise ValueError("engine must be 'xla' or 'pallas'.")

        args = tuple(jnp.asarray(a) for a in
                     (prec, mean_temp, etp, frac_ice, frac_solid_prec))
        obs_j = jnp.asarray(obs)
        names = self._param_list

        def objective(x):
            params = {name: x[i] for i, name in enumerate(names)}
            qsim, *_ = run_cemaneigegr4jice(
                *args, snow_pack_init, thermal_state_init, s_init, r_init,
                params)
            return loss(obs_j, qsim)

        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)
