"""Hydrological signature metrics (flow-duration-curve diagnostics).

The reference ships seven goodness-of-fit metrics; operational model
diagnosis additionally reads *signatures* -- behavior-targeted measures
that say WHERE a model is wrong, not just how much.  This module adds
the standard flow-duration-curve trio of Yilmaz, Gupta & Wagener (2008)
plus two hydrograph-shape measures, all as pure jittable reductions
over a time axis (batched over ensembles exactly like
:mod:`rrmpg_jax.utils.metrics`):

* :func:`fdc_fhv` -- peak-flow (high-segment volume) percent bias: is
  the model under-predicting floods?
* :func:`fdc_flv` -- low-flow (log-space low-segment volume) percent
  bias: are recessions/baseflow wrong?
* :func:`fdc_fms` -- mid-segment slope percent bias: is flow
  variability (flashiness of the FDC) wrong?
* :func:`flashiness` -- Richards-Baker flashiness index of a single
  series (day-to-day variability).
* :func:`runoff_ratio` -- long-term discharge over precipitation.

Sign conventions follow the common usage (also used by the CAMELS
benchmarking literature): positive FHV/FLV/FMS = the simulation
over-predicts that segment.

All functions sort internally, so inputs are plain hydrographs.  The
time axis is reduced; any other axes broadcast, so ``(T,)`` obs vs
``(T, N)`` sim with ``axis=0`` evaluates a whole ensemble in one call.
"""

import jax.numpy as jnp

__all__ = ["fdc_fhv", "fdc_flv", "fdc_fms", "flashiness",
           "runoff_ratio"]

_EPS = 1e-6


def _descending(x, axis):
    return -jnp.sort(-jnp.asarray(x), axis=axis)


def _exceedance_count(x, axis, fraction):
    """Static number of timesteps in the top ``fraction`` of the FDC."""
    T = x.shape[axis]
    return max(1, int(round(fraction * T)))


def fdc_fhv(obs, sim, h=0.02, axis=-1):
    """High-segment volume percent bias of the flow-duration curve.

    ``FHV = 100 * (sum(sim_top) - sum(obs_top)) / sum(obs_top)`` over
    the flows with exceedance probability <= ``h`` (default top 2%),
    each series sorted separately (Yilmaz et al. 2008, eq. A3).
    """
    obs = jnp.asarray(obs)
    sim = jnp.asarray(sim)
    k = _exceedance_count(obs, axis, h)
    obs_top = jnp.take(_descending(obs, axis), jnp.arange(k), axis=axis)
    sim_top = jnp.take(_descending(sim, axis), jnp.arange(k), axis=axis)
    num = jnp.sum(sim_top, axis=axis) - jnp.sum(obs_top, axis=axis)
    return 100.0 * num / (jnp.sum(obs_top, axis=axis) + _EPS)


def fdc_flv(obs, sim, l=0.3, axis=-1):
    """Low-segment (log-space) volume percent bias of the FDC.

    Measures the baseflow/recession volume: each series' bottom ``l``
    fraction in log space, referenced to its own minimum
    (Yilmaz et al. 2008, eq. A4; flows clipped at 1e-6 for dry series):
    ``FLV = 100 * (sum(log sim_low - log sim_min)
    - sum(log obs_low - log obs_min)) / sum(log obs_low - log obs_min)``.
    """
    obs = jnp.asarray(obs)
    sim = jnp.asarray(sim)
    T = obs.shape[axis]
    k = _exceedance_count(obs, axis, l)
    idx = jnp.arange(T - k, T)

    def low_volume(x):
        lo = jnp.log(jnp.maximum(
            jnp.take(_descending(x, axis), idx, axis=axis), _EPS))
        lo_min = jnp.min(lo, axis=axis, keepdims=True)
        return jnp.sum(lo - lo_min, axis=axis)

    v_obs = low_volume(obs)
    v_sim = low_volume(sim)
    return 100.0 * (v_sim - v_obs) / (v_obs + _EPS)


def fdc_fms(obs, sim, lower=0.2, upper=0.7, axis=-1):
    """Mid-segment slope percent bias of the FDC.

    The log-space FDC slope between the ``lower`` and ``upper``
    exceedance probabilities (default 20%-70%) measures flow
    variability; percent bias of sim vs obs slope
    (Yilmaz et al. 2008, eq. A2).
    """
    obs = jnp.asarray(obs)
    sim = jnp.asarray(sim)
    i_lo = _exceedance_count(obs, axis, lower) - 1
    i_hi = _exceedance_count(obs, axis, upper) - 1

    def slope(x):
        d = _descending(x, axis)
        q_lo = jnp.take(d, jnp.asarray([i_lo]), axis=axis)
        q_hi = jnp.take(d, jnp.asarray([i_hi]), axis=axis)
        return jnp.squeeze(
            jnp.log(jnp.maximum(q_lo, _EPS))
            - jnp.log(jnp.maximum(q_hi, _EPS)), axis=axis)

    s_obs = slope(obs)
    s_sim = slope(sim)
    return 100.0 * (s_sim - s_obs) / (s_obs + _EPS)


def flashiness(q, axis=-1):
    """Richards-Baker flashiness index: ``sum|dq| / sum q``.

    A shape signature of a single hydrograph (compare obs vs sim values
    rather than a bias): 0 for constant flow, larger for flashier
    catchments (Baker et al. 2004).
    """
    q = jnp.asarray(q)
    dq = jnp.abs(jnp.diff(q, axis=axis))
    return jnp.sum(dq, axis=axis) / (jnp.sum(q, axis=axis) + _EPS)


def runoff_ratio(q, prec, axis=-1):
    """Long-term runoff ratio ``sum(q) / sum(prec)`` (water balance)."""
    q = jnp.asarray(q)
    prec = jnp.asarray(prec)
    return jnp.sum(q, axis=axis) / (jnp.sum(prec, axis=axis) + _EPS)
