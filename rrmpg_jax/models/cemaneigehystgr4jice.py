"""Cemaneige-Hysteresis + degree-day ice melt + GR4J interface class.

API-compatible with the reference ``CemaneigeHystGR4JIce``
(``rrmpg/models/cemaneigehystgr4jice.py``): nine parameters (CTG, Kf,
Thacc, Rsp, x1..x4, DDF), ``fit(loss_metric='mse'|'kge')`` (minimizing
``1 - kge``, as the reference does for this class,
``cemaneigehystgr4jice.py:634``) and the multi-objective ``fit_Q_SCA``.
"""

import jax.numpy as jnp
import numpy as np

import functools

from ..ops.compositions import run_cemaneigehystgr4jice
from ..ops.uh import required_uh_lengths
from ..utils.array_checks import validate_array_input
from ._snow_base import CemaneigeBase
from .cemaneigehystgr4j import _loss_fn
from .gr4j import GR4J


class CemaneigeHystGR4JIce(CemaneigeBase):
    """Interface to the Cemaneige-Hysteresis + IceMelt + GR4J model."""

    _param_list = ['CTG', 'Kf', 'Thacc', 'Rsp', 'x1', 'x2', 'x3', 'x4',
                   'DDF']

    _default_bounds = {'CTG': (0, 1),
                       'Kf': (0, 10),
                       'Thacc': (0, 1000),
                       'Rsp': (0, 1),
                       'x1': (10, 1200),
                       'x2': (-5, 3),
                       'x3': (20, 5000),
                       'x4': (1.1, 10),
                       'DDF': (0, 30)}

    _dtype = np.dtype([('CTG', np.float64),
                       ('Kf', np.float64),
                       ('Thacc', np.float64),
                       ('Rsp', np.float64),
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
                   snow_pack_init, thermal_state_init, sca_init, s_init,
                   r_init, params):
            return run_cemaneigehystgr4jice(
                prec, mean_temp, etp, frac_ice, frac_solid_prec,
                snow_pack_init, thermal_state_init, sca_init, s_init,
                r_init, params, num_uh1, num_uh2)
        return kernel

    def _prepare(self, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                 met_station_height, altitudes, snow_pack_init,
                 thermal_state_init, sca_init, s_init, r_init,
                 extra_series=()):
        extra = (('pot. evapotranspiration', etp),) + tuple(extra_series)
        prec, mean_temp, frac_solid_prec, _, extras = self._validate_met(
            prec, mean_temp, min_temp, max_temp, met_station_height,
            altitudes, extra_series=extra)
        etp, extras = extras[0], extras[1:]
        frac_ice = self._validate_frac_ice(frac_ice)
        snow_pack_init = self._validate_number(snow_pack_init,
                                               'snow_pack_init')
        thermal_state_init = self._validate_number(thermal_state_init,
                                                   'thermal_state_init')
        sca_init = self._validate_number(sca_init, 'sca_init')
        s_init, r_init = GR4J._validate_inits(s_init, r_init)
        return (prec, mean_temp, frac_solid_prec, etp, frac_ice,
                snow_pack_init, thermal_state_init, sca_init, s_init,
                r_init, extras)

    def simulate(self, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
                 met_station_height, snow_pack_init=0, thermal_state_init=0,
                 sca_init=0, s_init=0, r_init=0, altitudes=[],
                 return_storage=False, params=None, mesh=None,
                 engine="xla", interpret=False, initial_state=None,
                 return_final_state=False):
        """Simulate the coupled hysteresis snow + ice + runoff model.

        Args as :meth:`CemaneigeHystGR4J.simulate` (including
        ``initial_state`` / ``return_final_state`` forecast mode), plus
        ``frac_ice``: (L,) glaciated fraction of each elevation layer.

        Returns:
            qsim (T, N); with ``return_storage`` the reference-ordered
            tuple (qsim, G, eTG, s_store, r_store, sca, ice_melt,
            snowmelt, rain) (``cemaneigehystgr4jice.py:303-306``), where
            G/eTG/sca/rain are (T, L, N), snowmelt is the (T, N)
            snow-routine outflow and ice_melt is (T, N); plus the final
            :class:`~rrmpg_jax.models.states.SnowGR4JState` if
            ``return_final_state``.
        """
        (prec, mean_temp, frac_solid_prec, etp, frac_ice, snow_pack_init,
         thermal_state_init, sca_init, s_init, r_init, _) = self._prepare(
            prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, altitudes, snow_pack_init,
            thermal_state_init, sca_init, s_init, r_init)
        inits = (snow_pack_init, thermal_state_init, sca_init, s_init,
                 r_init)
        self._check_no_cold_inits(
            initial_state, inits,
            ('snow_pack_init', 'thermal_state_init', 'sca_init', 's_init',
             'r_init'))

        param_dict, _ = self._prepare_params(params)
        if initial_state is not None or return_final_state:
            self._check_stateful_engine(engine, mesh, return_storage)
            n1, n2 = required_uh_lengths(param_dict['x4'])
            return self._simulate_stateful(
                hyst=True, ice=True, num_uh1=n1, num_uh2=n2,
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
                frac_ice=frac_ice, hyst=True, ice=True, interpret=interpret)
        if engine != "xla":
            raise ValueError("engine must be 'xla' or 'pallas'.")
        n1, n2 = required_uh_lengths(param_dict['x4'])
        outputs = self._run_batched(
            self._kernel_for(n1, n2),
            (prec, mean_temp, etp, frac_ice, frac_solid_prec,
             snow_pack_init, thermal_state_init, sca_init, s_init, r_init),
            param_dict, mesh=mesh)
        if return_storage:
            return outputs
        return outputs[0]

    def _warm_cycle_pieces(self, forcings, sim_kwargs):
        """Device-resident cycling pieces (see CemaneigeBase)."""
        return self._warm_cycle_pieces_snow(forcings, sim_kwargs,
                                            hyst=True, ice=True)

    def _fused_stats(self, qobs, param_dict, sim_kwargs):
        """Trajectory-free sufficient statistics for
        ``monte_carlo(return_qsim=False, engine='pallas')``
        (see :meth:`CemaneigeBase._fused_stats_family`)."""
        return self._fused_stats_family(qobs, param_dict,
                                        sim_kwargs, hyst=True,
                                        ice=True)

    def fit(self, obs, prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, loss_metric="mse", snow_pack_init=0,
            thermal_state_init=0, sca_init=0, s_init=0, r_init=0,
            altitudes=[], seed=None, engine="xla", interpret=False,
            initial_state=None, **de_kwargs):
        """Calibrate on observed discharge (device DE).

        Args:
            loss_metric: 'mse' or 'kge' (minimizes 1 - KGE).
            engine: 'xla', or 'pallas' for the fused ensemble kernel (KGE
                runs from on-device sufficient statistics).
            initial_state: (optional) single-member
                :class:`~rrmpg_jax.models.states.SnowGR4JState` (hyst
                snow half) -- calibrate a continuation segment from a
                known initial condition (``engine='xla'`` only).

        Returns:
            An :class:`~rrmpg_jax.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize

        loss = _loss_fn(loss_metric)
        obs = validate_array_input(obs, np.float64, 'obs')
        (prec, mean_temp, frac_solid_prec, etp, frac_ice, snow_pack_init,
         thermal_state_init, sca_init, s_init, r_init, _) = self._prepare(
            prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, altitudes, snow_pack_init,
            thermal_state_init, sca_init, s_init, r_init)
        self._check_no_cold_inits(
            initial_state,
            (snow_pack_init, thermal_state_init, sca_init, s_init, r_init),
            ('snow_pack_init', 'thermal_state_init', 'sca_init', 's_init',
             'r_init'))

        bounds = tuple(self._default_bounds[p] for p in self._param_list)

        if initial_state is not None:
            return self._warm_fit_de(
                hyst=True, ice=True, engine=engine,
                initial_state=initial_state, prec=prec,
                mean_temp=mean_temp, etp=etp,
                frac_solid_prec=frac_solid_prec, obs=obs, loss=loss,
                seed=seed, de_kwargs=de_kwargs, frac_ice=frac_ice,
                loss_metric=loss_metric, interpret=interpret)

        if engine == "pallas":
            batch_objective = self._pallas_batch_objective(
                loss_metric, prec, mean_temp, etp, frac_solid_prec, obs,
                snow_pack_init, thermal_state_init, s_init, r_init,
                frac_ice=frac_ice, hyst=True, ice=True, interpret=interpret)
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
            qsim, *_ = run_cemaneigehystgr4jice(
                *args, snow_pack_init, thermal_state_init, sca_init, s_init,
                r_init, params)
            return loss(obs_j, qsim)

        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)

    def fit_Q_SCA(self, obs, prec, mean_temp, min_temp, max_temp, etp,
                  frac_ice, NDSI1, NDSI2, NDSI3, NDSI4, NDSI5,
                  met_station_height, loss_metric="mse", snow_pack_init=0,
                  thermal_state_init=0, sca_init=0, s_init=0, r_init=0,
                  altitudes=[], seed=None, engine="xla", interpret=False,
                  initial_state=None, pareto=False, **de_kwargs):
        """Multi-objective calibration on discharge + snow-covered area.

        Loss = ``0.75 * L(obs, qsim) + 0.05 * sum_b L(NDSI_b, 100*sca_b)``
        over the five elevation bands (reference
        ``cemaneigehystgr4jice.py:640-717``).  ``initial_state``
        calibrates a continuation segment from a known initial condition
        (``engine='xla'`` only).  ``pareto=True`` optimizes
        ``(L_q, L_sca)`` as a true bi-objective problem with
        :func:`rrmpg_jax.tools.moo.nsga2` and returns the full front
        (see :meth:`CemaneigeHystGR4J.fit_Q_SCA`).

        Returns:
            An :class:`~rrmpg_jax.tools.calibration.OptimizeResult`.
        """
        from ..tools.calibration import minimize

        loss = _loss_fn(loss_metric)
        obs = validate_array_input(obs, np.float64, 'obs')
        ndsi_series = tuple(
            ('NDSI{}'.format(i + 1), arr)
            for i, arr in enumerate((NDSI1, NDSI2, NDSI3, NDSI4, NDSI5)))
        (prec, mean_temp, frac_solid_prec, etp, frac_ice, snow_pack_init,
         thermal_state_init, sca_init, s_init, r_init, ndsi) = self._prepare(
            prec, mean_temp, min_temp, max_temp, etp, frac_ice,
            met_station_height, altitudes, snow_pack_init,
            thermal_state_init, sca_init, s_init, r_init,
            extra_series=ndsi_series)
        self._check_no_cold_inits(
            initial_state,
            (snow_pack_init, thermal_state_init, sca_init, s_init, r_init),
            ('snow_pack_init', 'thermal_state_init', 'sca_init', 's_init',
             'r_init'))

        bounds = tuple(self._default_bounds[p] for p in self._param_list)

        if pareto and initial_state is not None:
            raise ValueError(
                "fit_Q_SCA(pareto=True) supports cold starts only; run "
                "the scalarized fit for the warm path.")

        if initial_state is not None:
            return self._warm_fit_de(
                hyst=True, ice=True, engine=engine,
                initial_state=initial_state, prec=prec,
                mean_temp=mean_temp, etp=etp,
                frac_solid_prec=frac_solid_prec, obs=obs, loss=loss,
                seed=seed, de_kwargs=de_kwargs, frac_ice=frac_ice,
                ndsi=ndsi, loss_metric=loss_metric, interpret=interpret)

        if engine == "pallas":
            batch_objective = self._pallas_q_sca_objective(
                loss_metric, prec, mean_temp, etp, frac_solid_prec, obs,
                ndsi, snow_pack_init, thermal_state_init, s_init, r_init,
                frac_ice=frac_ice, ice=True, interpret=interpret,
                components=pareto)
            if pareto:
                from ..tools.moo import nsga2
                return nsga2(batch_objective, bounds, seed=seed,
                             batched=True, **de_kwargs)
            return minimize(batch_objective, bounds,
                                          seed=seed, batched=True,
                                          **de_kwargs)
        if engine != "xla":
            raise ValueError("engine must be 'xla' or 'pallas'.")

        args = tuple(jnp.asarray(a) for a in
                     (prec, mean_temp, etp, frac_ice, frac_solid_prec))
        obs_j = jnp.asarray(obs)
        ndsi_j = jnp.stack([jnp.asarray(n) for n in ndsi])  # (5, T)
        names = self._param_list

        def q_sca_losses(x):
            params = {name: x[i] for i, name in enumerate(names)}
            qsim, _, _, _, _, sca, _, _, _ = run_cemaneigehystgr4jice(
                *args, snow_pack_init, thermal_state_init, sca_init, s_init,
                r_init, params)
            loss_q = loss(obs_j, qsim)
            sca_bands = 100.0 * sca.T  # (L, T)
            loss_sca = sum(loss(ndsi_j[b], sca_bands[b]) for b in range(5))
            return loss_q, loss_sca

        if pareto:
            from ..tools.moo import nsga2

            def objectives(x):
                loss_q, loss_sca = q_sca_losses(x)
                return jnp.stack([loss_q, loss_sca])

            return nsga2(objectives, bounds, seed=seed, **de_kwargs)

        def objective(x):
            loss_q, loss_sca = q_sca_losses(x)
            return 0.75 * loss_q + 0.05 * loss_sca

        return minimize(objective, bounds, seed=seed,
                                      **de_kwargs)
