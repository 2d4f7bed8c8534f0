"""Test configuration: CPU backend, 8 virtual devices, dtype lane switch.

Golden-data validation runs against the reference's float64 Excel/MATLAB
trajectories, so the DEFAULT lane forces x64 on a CPU mesh (8 virtual
devices to exercise the sharding paths without accelerator hardware).

Large ensembles run in float32, and the multi-device dry run executes
under default-f32 -- a precision the x64 lane never touches.  Setting
``RRMPG_TEST_DTYPE=float32`` switches the suite to that dtype; tests
whose assertions genuinely need float64 (tight golden tolerances,
bit-parity oracles) carry ``@pytest.mark.f64only`` and are skipped in
that lane.  CI runs both lanes.

Checks that need the GPU carry ``@pytest.mark.gpu`` and the ``gpu``
fixture of their module, which skips them here; ``python chip_smoke.py``
runs them on the card.
"""

import os

import pytest

# Must be set before the first jax backend initialization.
os.environ.setdefault("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax

TEST_DTYPE = os.environ.get("RRMPG_TEST_DTYPE", "float64")
if TEST_DTYPE not in ("float32", "float64"):
    raise ValueError(
        f"RRMPG_TEST_DTYPE={TEST_DTYPE!r}; expected float32 or float64.")

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", TEST_DTYPE == "float64")

# Persistent XLA compilation cache: repeat suite runs skip most
# compiles (the wall-clock is compile-dominated).
#
# The cache directory is keyed by a HOST CPU SIGNATURE: XLA:CPU stores
# AOT-compiled machine code, and a cache populated on a machine with
# different CPU features loads with
#   "cpu_aot_loader: ... Machine type used for XLA:CPU compilation
#    doesn't match the machine type for execution ... could lead to
#    execution errors such as SIGILL."
# Executing such entries is the identified mechanism behind the
# "sporadic segfault deep into long single-process runs" observed in
# rounds 2-3 (it needs a stale cross-machine cache hit, which is why it
# never reproduced in isolation on a fresh compile).  Keying by host
# flags makes a box change start a clean cache instead.
def _host_cache_tag():
    import hashlib
    import platform

    sig = platform.machine() + platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    sig += line
                    break
    except OSError:
        pass
    return hashlib.sha1(sig.encode()).hexdigest()[:12]


# A cache directory placed from outside (JAX_COMPILATION_CACHE_DIR) is
# used as it is; JAX reads the variable itself.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = os.path.join(os.path.dirname(__file__), ".jax_cache",
                              _host_cache_tag())
    jax.config.update("jax_compilation_cache_dir", _cache_dir)

# Cache-WRITE exposure is the second identified crash mechanism: a
# round-4 run with PYTHONFAULTHANDLER=1 caught the long-standing
# "sporadic segfault" inside jax/_src/compilation_cache.py::
# put_executable_and_time -> executable.serialize() (XLA:CPU executable
# serialization, C++), ~40 slow tests deep -- and the same test passes
# in isolation because a warm cache never serializes.  Only caching
# executables that took real time to compile cuts serialize calls (and
# the crash surface) by an order of magnitude while keeping the wins
# that matter; a fully warm cache performs no writes at all.
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

# Always-on crash stacks: if the serialize() segfault (or anything
# else) fires, the signature lands in the log instead of a bare
# "Segmentation fault".
import faulthandler

faulthandler.enable()


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_cache():
    """Clear JAX's in-process executable caches after every test module.

    ROOT CAUSE of the rounds-2/3 "sporadic segfault deep into long
    single-process runs" (fully diagnosed in round 4): every jitted
    executable's code pages stay mmap'd in the never-evicted in-process
    jit cache; ~40 slow tests in, the process carries >60k memory maps
    and crosses the kernel's default ``vm.max_map_count`` (65530).  The
    next mmap inside XLA:CPU C++ fails unchecked and SIGSEGVs at
    whatever heavy operation runs next (compile, serialize, cache
    deserialize -- all three signatures were captured via
    faulthandler), which is why the crash site wandered, it scaled with
    run length, and isolation always passed (fresh process, low map
    count).  Raising the sysctl also fixes it, but clearing per module
    keeps the suite within default limits on any machine; the
    persistent compile cache makes the cross-module recompiles cheap
    deserializes.
    """
    yield
    import jax

    jax.clear_caches()


def pytest_collection_modifyitems(config, items):
    if TEST_DTYPE == "float64":
        return
    skip_f64 = pytest.mark.skip(
        reason="needs float64 (golden-parity tolerance); "
               "RRMPG_TEST_DTYPE=float32 lane")
    for item in items:
        if "f64only" in item.keywords:
            item.add_marker(skip_f64)
