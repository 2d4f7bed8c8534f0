"""Native (C++) oracle kernel library.

Ships the sequential reference kernels as a small C++ shared library,
compiled on first use with the system toolchain and bound via ctypes.
Two roles:

* an independent, JAX-free oracle the test suite cross-validates the
  Pallas/XLA kernels against (a second implementation of the model math,
  in a different language, catching shared-blind-spot bugs);
* a fast sequential CPU fallback for environments without an accelerator
  -- the role numba's LLVM JIT plays in the reference package.

Use :func:`available` to probe, and the ``oracle_*`` wrappers mirroring
the signatures of :mod:`rrmpg_jax.ops`.
"""

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "oracle.cpp"
_LIB = Path(__file__).parent / "liboracle.so"
_lib = None
_build_error = None


def _build():
    # Build under a private name and rename into place: processes that
    # build at once (test workers) never load a half-written library.
    tmp = _LIB.with_name(f"{_LIB.stem}.{os.getpid()}.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
           "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def _load():
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise RuntimeError(_build_error)
    try:
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(_LIB))
    except (OSError, subprocess.CalledProcessError) as e:
        _build_error = f"native oracle unavailable: {e}"
        raise RuntimeError(_build_error)

    d = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    c_d, c_i = ctypes.c_double, ctypes.c_int64
    lib.oracle_abc.argtypes = [d, c_i, c_d, c_d, c_d, c_d, d, d]
    lib.oracle_gr4j.argtypes = [d, d, c_i, c_d, c_d, c_d, c_d, c_d, c_d,
                                d, d, d]
    lib.oracle_hbvedu.argtypes = ([d, d, i64, d, d, c_i] +
                                  [c_d] * 15 + [d] * 5)
    lib.oracle_cemaneige.argtypes = [d, d, d, c_i, c_i, c_d, c_d, c_d,
                                     c_d, d, d, d]
    lib.oracle_cemaneigehyst.argtypes = [d, d, d, c_i, c_i, c_d, c_d, c_d,
                                         c_d, c_d, c_d, d, d, d, d, d]
    lib.oracle_icemelt.argtypes = [d, d, c_i, c_i, c_d, d]
    _lib = lib
    return lib


def available() -> bool:
    """True if the native library can be built/loaded on this machine."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _c(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def oracle_abc(prec, initial_state, params):
    """C++ oracle for the ABC model; mirrors ``ops.run_abcmodel``."""
    lib = _load()
    prec = _c(prec)
    T = prec.shape[0]
    qsim = np.zeros(T)
    storage = np.zeros(T)
    lib.oracle_abc(_dp(prec), T, float(params['a']), float(params['b']),
                   float(params['c']), float(initial_state), _dp(qsim),
                   _dp(storage))
    return qsim, storage


def oracle_gr4j(prec, etp, s_init, r_init, params):
    """C++ oracle for GR4J; mirrors ``ops.run_gr4j``."""
    lib = _load()
    prec, etp = _c(prec), _c(etp)
    T = prec.shape[0]
    qsim = np.zeros(T)
    s_store = np.zeros(T)
    r_store = np.zeros(T)
    lib.oracle_gr4j(_dp(prec), _dp(etp), T, float(params['x1']),
                    float(params['x2']), float(params['x3']),
                    float(params['x4']), float(s_init), float(r_init),
                    _dp(qsim), _dp(s_store), _dp(r_store))
    return qsim, s_store, r_store


def oracle_hbvedu(temp, prec, month, pe_m, t_m, snow_init, soil_init,
                  s1_init, s2_init, params):
    """C++ oracle for HBV-Edu; mirrors ``ops.run_hbvedu``."""
    lib = _load()
    temp, prec = _c(temp), _c(prec)
    month = np.ascontiguousarray(np.asarray(month, dtype=np.int64))
    pe_m, t_m = _c(pe_m), _c(t_m)
    T = prec.shape[0]
    outs = [np.zeros(T) for _ in range(5)]
    lib.oracle_hbvedu(
        _dp(temp), _dp(prec),
        month.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _dp(pe_m), _dp(t_m), T,
        *(float(params[k]) for k in ('T_t', 'DD', 'FC', 'Beta', 'C', 'PWP',
                                     'K_0', 'K_1', 'K_2', 'K_p', 'L')),
        float(snow_init), float(soil_init), float(s1_init), float(s2_init),
        *(_dp(o) for o in outs))
    return tuple(outs)


def oracle_cemaneige(prec, mean_temp, frac_solid_prec, snow_pack_init,
                     thermal_state_init, params):
    """C++ oracle for Cemaneige; mirrors ``ops.run_cemaneige``."""
    lib = _load()
    prec, mean_temp = _c(prec), _c(mean_temp)
    frac = _c(frac_solid_prec)
    T, L = prec.shape
    outflow = np.zeros(T)
    G = np.zeros((T, L))
    eTG = np.zeros((T, L))
    lib.oracle_cemaneige(_dp(prec), _dp(mean_temp), _dp(frac), T, L,
                         float(params['CTG']), float(params['Kf']),
                         float(snow_pack_init), float(thermal_state_init),
                         _dp(outflow), _dp(G), _dp(eTG))
    return outflow, G, eTG


def oracle_cemaneigehyst(prec, mean_temp, frac_solid_prec, snow_pack_init,
                         thermal_state_init, sca_init, params):
    """C++ oracle for Cemaneige-Hysteresis; mirrors
    ``ops.run_cemaneigehyst`` (``sca_init`` is inert, see that kernel)."""
    del sca_init
    lib = _load()
    prec, mean_temp = _c(prec), _c(mean_temp)
    frac = _c(frac_solid_prec)
    T, L = prec.shape
    outflow = np.zeros(T)
    G, eTG, sca, rain = (np.zeros((T, L)) for _ in range(4))
    lib.oracle_cemaneigehyst(
        _dp(prec), _dp(mean_temp), _dp(frac), T, L,
        float(params['CTG']), float(params['Kf']), float(params['Thacc']),
        float(params['Rsp']), float(snow_pack_init),
        float(thermal_state_init), _dp(outflow), _dp(G), _dp(eTG),
        _dp(sca), _dp(rain))
    return outflow, G, eTG, sca, rain


def oracle_icemelt(temp, snow, params):
    """C++ oracle for degree-day ice melt; mirrors ``ops.run_icemelt``."""
    lib = _load()
    temp, snow = _c(temp), _c(snow)
    T, L = temp.shape
    liquid = np.zeros((T, L))
    lib.oracle_icemelt(_dp(temp), _dp(snow), T, L, float(params['DDF']),
                       _dp(liquid))
    return liquid
