"""Global configuration helpers for rrmpg-jax.

The reference implementation computes everything in float64
(``rrmpg/models/basemodel.py:28-35`` declares float64 structured dtypes).
rrmpg-jax computes in JAX's default dtype: float32 unless
``jax_enable_x64`` is switched on.  Large ensembles run in float32, where
the fused kernels and the card's vector units are fastest; the GPU also
runs float64 natively, so golden-data validation (Excel/MATLAB
trajectories) runs in float64 on either backend -- see
``tests/conftest.py`` and ``chip_smoke.py``.
"""

import os

import jax
import jax.numpy as jnp


def enable_x64(enable: bool = True) -> None:
    """Enable (or disable) float64 computation globally.

    Use this for bit-parity validation against the float64 reference
    implementation; large float32 ensembles leave it off.
    """
    jax.config.update("jax_enable_x64", enable)


def default_float():
    """The current default floating dtype (float64 iff x64 is enabled)."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def enable_compile_cache(default_dir):
    """Turn on JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses that
    directory and no other is set here; otherwise the cache lives in
    ``default_dir`` (scripts pass a fixed ``.jax_cache/`` beside
    themselves, so repeated runs from one checkout hit it).

    Returns:
        The cache directory in use.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.abspath(default_dir)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
