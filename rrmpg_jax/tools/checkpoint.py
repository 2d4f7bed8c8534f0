"""Checkpoint / resume for long-running calibrations and ensembles.

The reference has no persistence at all -- interrupted fits restart from
scratch (SURVEY.md section 5).  Here any pytree of arrays (DE population +
PRNG key + generation counter, Monte-Carlo best-so-far, model parameter
dicts) round-trips through a single ``.npz`` file with atomic replacement,
so multi-host runs survive preemption.
"""

import os
import tempfile

import numpy as np

_META_PREFIX = "__meta__"


def save_checkpoint(path, state, metadata=None):
    """Atomically write a flat dict of arrays (+ scalar metadata) to disk.

    Args:
        path: target filename (conventionally ``*.npz``).
        state: dict mapping names to arrays / array-likes (device arrays
            are fetched to host).
        metadata: (optional) dict of small scalars/strings stored alongside.
    """
    payload = {k: np.asarray(v) for k, v in state.items()}
    for k, v in (metadata or {}).items():
        payload[_META_PREFIX + k] = np.asarray(v)

    directory = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path):
    """Load a checkpoint written by :func:`save_checkpoint`.

    Returns:
        dict of arrays; metadata entries are returned under a
        ``'metadata'`` sub-dict.
    """
    with np.load(path, allow_pickle=False) as data:
        state = {}
        metadata = {}
        for k in data.files:
            if k.startswith(_META_PREFIX):
                metadata[k[len(_META_PREFIX):]] = data[k][()]
            else:
                state[k] = data[k]
    if metadata:
        state['metadata'] = metadata
    return state


def save_checkpoint_orbax(path, state):
    """Write a pytree checkpoint with Orbax (multi-host runs).

    The ``.npz`` functions above are single-host; Orbax coordinates a
    distributed save in which every process writes its shards of sharded
    arrays and a single process commits atomically -- the right backend
    once calibrations span hosts.  The npz path remains the default for
    single-host runs (no extra dependency surface).

    Args:
        path: target checkpoint directory (created/overwritten).
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, state, force=True)


def load_checkpoint_orbax(path, abstract_state=None):
    """Load an Orbax checkpoint written by :func:`save_checkpoint_orbax`.

    Args:
        abstract_state: (optional) pytree of ``jax.ShapeDtypeStruct`` (or
            arrays) with sharding annotations; when given, arrays restore
            directly into those shardings (each host reads only its
            shards).
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    with ocp.StandardCheckpointer() as ckptr:
        if abstract_state is not None:
            return ckptr.restore(path, abstract_state)
        return ckptr.restore(path)


def save_state(path, state):
    """Persist a simulation state bundle between forecast cycles.

    Serializes any of the class-level bundles
    (:mod:`rrmpg_jax.models.states` -- including the nested
    ``SnowGR4JState``) to the atomic-npz format, recording the bundle
    type so :func:`load_state` reconstructs the exact pytree to pass
    back as ``simulate(initial_state=)``.

    Args:
        path: target filename (conventionally ``*.npz``).
        state: a state bundle as returned by
            ``simulate(..., return_final_state=True)``.
    """
    from ..models import states as _states
    from ..ops.gr4j import GR4JState

    known = {cls.__name__: cls for cls in
             (_states.ABCState, _states.HBVEduState,
              _states.CemaneigeState, _states.CemaneigeHystState,
              _states.SnowGR4JState, GR4JState)}
    cls_name = type(state).__name__
    if cls_name not in known:
        raise TypeError(
            f"save_state expects a state bundle; got {cls_name}. "
            "For arbitrary pytrees use save_checkpoint.")

    if cls_name == "SnowGR4JState":
        flat = {f"snow.{f}": np.asarray(v)
                for f, v in zip(type(state.snow)._fields, state.snow)}
        flat.update({f"gr4j.{f}": np.asarray(v)
                     for f, v in zip(GR4JState._fields, state.gr4j)})
        meta = {"bundle": cls_name,
                "snow_bundle": type(state.snow).__name__}
    else:
        flat = {f: np.asarray(v)
                for f, v in zip(type(state)._fields, state)}
        meta = {"bundle": cls_name}
    save_checkpoint(path, flat, metadata=meta)


def load_state(path):
    """Reconstruct a state bundle written by :func:`save_state`."""
    from ..models import states as _states
    from ..ops.gr4j import GR4JState

    known = {cls.__name__: cls for cls in
             (_states.ABCState, _states.HBVEduState,
              _states.CemaneigeState, _states.CemaneigeHystState,
              GR4JState)}
    data = load_checkpoint(path)
    meta = data.pop("metadata", {})
    bundle = str(meta.get("bundle", ""))
    if bundle == "SnowGR4JState":
        snow_cls = known[str(meta["snow_bundle"])]
        snow = snow_cls(*(data[f"snow.{f}"] for f in snow_cls._fields))
        gr4j = GR4JState(*(data[f"gr4j.{f}"]
                           for f in GR4JState._fields))
        return _states.SnowGR4JState(snow=snow, gr4j=gr4j)
    if bundle in known:
        cls = known[bundle]
        return cls(*(data[f] for f in cls._fields))
    raise ValueError(
        f"{path!r} does not hold a state bundle (bundle tag "
        f"{bundle!r}); was it written by save_state?")
