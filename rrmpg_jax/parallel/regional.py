"""Regional (multi-catchment) execution.

The reference simulates one catchment per call; regional studies loop in
user code.  Here the catchment axis is a first-class batch dimension:
``regional_run`` vmaps a single-catchment kernel over stacked forcings,
optionally crossed with a parameter-ensemble axis, and shards either axis
over a 2-D (ensemble, catchment) device mesh.

Axis layout of the result: ``(C, ...)`` for shared parameters,
``(C, N, ...)`` when an ensemble dict of (N,) parameter arrays is passed.
"""

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .mesh import CATCHMENT_AXIS, ENSEMBLE_AXIS


@functools.lru_cache(maxsize=None)
def _regional_fn(kernel, n_forcing, ensemble):
    per_catchment = jax.vmap(kernel,
                             in_axes=(0,) * n_forcing + (None,))
    if ensemble:
        # params mapped over axis 0, forcings shared within the inner vmap.
        fn = jax.vmap(per_catchment,
                      in_axes=(None,) * n_forcing + (0,),
                      out_axes=1)
    else:
        fn = per_catchment
    return jax.jit(fn)


def regional_run(kernel, forcings, params, mesh=None):
    """Run a single-catchment kernel over a batch of catchments.

    Args:
        kernel: pure function ``kernel(*forcings_one_catchment, params)``.
        forcings: tuple of arrays with a leading catchment axis (C, ...).
        params: dict of scalars (shared parameters) or of (N,) arrays
            (parameter ensemble crossed with every catchment).
        mesh: optional device mesh; the catchment axis (and the ensemble
            axis, if present) are sharded over the matching mesh axes.

    Returns:
        Tuple of outputs with leading axis C (shared params) or axes
        (C, N) (ensemble).
    """
    forcings = tuple(jnp.asarray(f) for f in forcings)
    leaf = jax.tree.leaves(params)[0]
    ensemble = jnp.ndim(leaf) > 0

    if mesh is not None:
        cat = NamedSharding(mesh, P(CATCHMENT_AXIS))
        forcings = tuple(jax.device_put(f, cat) for f in forcings)
        if ensemble and ENSEMBLE_AXIS in mesh.shape:
            ens = NamedSharding(mesh, P(ENSEMBLE_AXIS))
            params = jax.tree.map(lambda x: jax.device_put(x, ens), params)

    fn = _regional_fn(kernel, len(forcings), ensemble)
    outputs = fn(*forcings, params)
    if not isinstance(outputs, tuple):
        outputs = (outputs,)
    return outputs


def _regional_loss(loss_metric):
    """Per-catchment minimization loss for the regional objectives."""
    from ..utils.metrics import calibration_loss

    if loss_metric not in ("mse", "rmse", "nse", "kge"):
        raise ValueError(
            f"Unsupported loss_metric {loss_metric!r}; supported: "
            "'mse', 'rmse', 'nse', 'kge'.")
    return calibration_loss(loss_metric)


def _losses_from_regional_stats(stats, qobs, loss_metric):
    """(4, C, N) fused statistics -> (C, N) minimization losses."""
    from ..ops.pallas_snow import losses_from_stats

    if loss_metric in ("mse", "rmse"):
        out = stats[0]
        return jnp.sqrt(out) if loss_metric == "rmse" else out
    per_catchment = jax.vmap(
        lambda s, qo: losses_from_stats(s, qo)[loss_metric],
        in_axes=(1, 0))
    return 1.0 - per_catchment(stats, qobs)             # (C, N)


def regional_gr4j_objective(prec, etp, qobs, s_init, r_init, params,
                            mesh=None, engine="pallas", interpret=False,
                            loss_metric="mse", **kernel_kwargs):
    """(Catchment x member) GR4J objective sweep; returns (C, N) losses.

    The regional Monte-Carlo / calibration hot path.  With
    ``engine='pallas'`` the fused regional kernel runs the whole cross
    product in one launch (one float per (catchment, member) reaches
    device memory for 'mse'/'rmse'; four for the sufficient-statistics
    metrics); ``engine='xla'`` is the double-vmap reference.  On a 2-D
    mesh the catchment axis shards over ``catchment`` and the member
    axis over ``ensemble``, each card running the fused kernel on its
    local tile.

    Args:
        prec, etp, qobs: (C, T) per-catchment series.
        s_init, r_init: scalar GR4J store initializations.
        params: dict of (N,) parameter arrays, shared across catchments.
        mesh: optional 2-D (ensemble, catchment) mesh.
        loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge' minimizing
            ``1 - score`` per catchment (the fused engine accumulates
            the sufficient statistics on-device).
        kernel_kwargs: forwarded to the fused kernel (num_uh1, block...).
    """
    import numpy as np

    from ..ops.pallas_gr4j import gr4j_regional_mse_pallas
    from ..ops.gr4j import run_gr4j

    loss = _regional_loss(loss_metric)
    use_stats = loss_metric in ("nse", "kge")
    prec, etp, qobs = (jnp.asarray(a) for a in (prec, etp, qobs))
    # NaN observations = missing-data gaps (ragged/gapped records):
    # the XLA metric masks inherently; the fused kernel gets the masked
    # specialization only when gaps exist.
    kernel_kwargs.setdefault("masked",
                             bool(np.isnan(np.asarray(qobs)).any()))

    if engine == "pallas":
        def local(pr, et, qo, pa):
            out = gr4j_regional_mse_pallas(pr, et, qo, s_init, r_init,
                                           pa, interpret=interpret,
                                           stats=use_stats,
                                           **kernel_kwargs)
            if use_stats:
                return _losses_from_regional_stats(out, qo, loss_metric)
            if loss_metric == "rmse":
                return jnp.sqrt(out)
            return out
    elif engine == "xla":
        def local(pr, et, qo, pa):
            def member(p):
                def catchment(pr1, et1, qo1):
                    q, _, _ = run_gr4j(pr1, et1, s_init, r_init, p)
                    return loss(qo1, q)
                return jax.vmap(catchment)(pr, et, qo)   # (C,)
            return jax.vmap(member, out_axes=1)(pa)      # (C, N)
    else:
        raise ValueError(
            f"Unsupported engine {engine!r}; use 'xla' or 'pallas'.")

    if mesh is None:
        return jax.jit(local)(prec, etp, qobs, params)

    from .mesh import relaxed_shard_map

    fn = relaxed_shard_map(
        local, mesh,
        in_specs=(P(CATCHMENT_AXIS), P(CATCHMENT_AXIS), P(CATCHMENT_AXIS),
                  P(ENSEMBLE_AXIS)),
        out_specs=P(CATCHMENT_AXIS, ENSEMBLE_AXIS))
    return jax.jit(fn)(prec, etp, qobs, params)


def _composition_qsim(hyst, ice, snow_pack_init, thermal_state_init,
                      s_init, r_init, num_uh1, num_uh2):
    """``qsim(prec, mean_temp, etp, frac_solid_prec, frac_ice, params)`` of
    one snow+GR4J composition variant on the ``xla`` engine."""
    from ..ops import compositions as comp

    inits = (snow_pack_init, thermal_state_init)
    sca = (0.0,) if hyst else ()    # sca_init is inert (reference quirk)
    uh = dict(num_uh1=num_uh1, num_uh2=num_uh2)
    run = {(False, False): comp.run_cemaneigegr4j,
           (True, False): comp.run_cemaneigehystgr4j,
           (False, True): comp.run_cemaneigegr4jice,
           (True, True): comp.run_cemaneigehystgr4jice}[(hyst, ice)]

    def qsim(pr, mt, et, fs, fi, p):
        fi_arg = (fi,) if ice else ()
        return run(pr, mt, et, *fi_arg, fs, *inits, *sca, s_init, r_init,
                   p, **uh)[0]

    return qsim


def regional_snow_objective(prec, mean_temp, etp, frac_solid_prec, qobs,
                            snow_pack_init, thermal_state_init, s_init,
                            r_init, params, frac_ice=None, hyst=False,
                            ice=False, mesh=None, interpret=False,
                            loss_metric="mse", engine="pallas",
                            **kernel_kwargs):
    """(Catchment x member) coupled snow+GR4J sweep -> (C, N) losses.

    The snow-family counterpart of :func:`regional_gr4j_objective`.  With
    ``engine='pallas'`` it runs the fused regional kernel
    (:func:`rrmpg_jax.ops.pallas_snow.snowgr4j_regional_mse_pallas`):
    per-catchment layer forcing, snow thresholds and glacier fractions,
    one float per (catchment, member) to device memory ('mse'/'rmse';
    four for the sufficient-statistics metrics); ``engine='xla'`` is the
    double vmap over the composition kernels.  On a 2-D mesh the
    catchment axis shards over ``catchment`` and members over
    ``ensemble`` via shard_map.

    Args:
        prec, mean_temp, frac_solid_prec: (C, T, L) layer forcing.
        etp, qobs: (C, T) series.
        params: dict of (N,) member parameter arrays.
        frac_ice: (L,) shared or (C, L) per-catchment glacier fractions.
        hyst, ice: composition variant selectors.
        loss_metric: 'mse' (default), 'rmse', or 'nse'/'kge' minimizing
            ``1 - score`` per catchment.
        engine: 'pallas' (fused kernel) or 'xla'.
        kernel_kwargs: forwarded to the fused kernel (num_uh1, num_uh2,
            block, masked); the ``xla`` engine takes only
            num_uh1/num_uh2.
    """
    import numpy as np

    from ..ops.pallas_snow import snowgr4j_regional_mse_pallas
    from ..ops.uh import NUM_UH1, NUM_UH2

    loss = _regional_loss(loss_metric)
    use_stats = loss_metric in ("nse", "kge")
    arrays = tuple(jnp.asarray(a) for a in
                   (prec, mean_temp, etp, frac_solid_prec, qobs))
    # NaN observations = missing-data gaps -> masked kernel
    # specialization (per-catchment valid-count normalization).
    kernel_kwargs.setdefault("masked",
                             bool(np.isnan(np.asarray(arrays[4])).any()))
    # Glacier fractions are (C, L) on every path (zeros without ice).
    C, _, L = arrays[0].shape
    args = arrays + (jnp.broadcast_to(jnp.asarray(
        0.0 if frac_ice is None else frac_ice, arrays[0].dtype), (C, L)),)

    if engine == "pallas":
        def local(pr, mt, et, fs, qo, fi, pa):
            out = snowgr4j_regional_mse_pallas(
                pr, mt, et, fs, qo, snow_pack_init, thermal_state_init,
                s_init, r_init, pa, frac_ice=fi, hyst=hyst, ice=ice,
                interpret=interpret, stats=use_stats, **kernel_kwargs)
            if use_stats:
                return _losses_from_regional_stats(out, qo, loss_metric)
            if loss_metric == "rmse":
                return jnp.sqrt(out)
            return out
    elif engine == "xla":
        qsim = _composition_qsim(
            hyst, ice, snow_pack_init, thermal_state_init, s_init, r_init,
            kernel_kwargs.get("num_uh1", NUM_UH1),
            kernel_kwargs.get("num_uh2", NUM_UH2))

        def local(pr, mt, et, fs, qo, fi, pa):
            def member(p):
                def catchment(pr1, mt1, et1, fs1, qo1, fi1):
                    return loss(qo1, qsim(pr1, mt1, et1, fs1, fi1, p))
                return jax.vmap(catchment)(pr, mt, et, fs, qo, fi)
            return jax.vmap(member, out_axes=1)(pa)      # (C, N)
    else:
        raise ValueError(
            f"Unsupported engine {engine!r}; use 'xla' or 'pallas'.")

    if mesh is None:
        return local(*args, params)

    from .mesh import relaxed_shard_map

    fn = relaxed_shard_map(
        local, mesh, in_specs=(P(CATCHMENT_AXIS),) * 6 + (P(ENSEMBLE_AXIS),),
        out_specs=P(CATCHMENT_AXIS, ENSEMBLE_AXIS))
    return jax.jit(fn)(*args, params)
