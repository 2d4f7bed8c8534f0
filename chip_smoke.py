"""Run the ensemble objective end to end on an NVIDIA GPU and check it.

    python chip_smoke.py          # one card: phases 1-7 below
    python chip_smoke.py --four   # four cards: the sharded paths only

One card, one process, in order; the first failed phase stops the run
with a non-zero exit:

1. Device: platform, kind, count, and the card's name and power limit.
   Without a GPU the script exits non-zero before any other phase.
2. Golden parity in float64 on the card (``xla`` engine).
3. The main path at full width through the public API, on the first
   3,651 days of the bundled CAMELS basin: Monte-Carlo ensembles of
   131,072 members (GR4J, CemaneigeHystGR4JIce over 5 layers, HBV-Edu),
   a fused GR4J fit, and both regional objectives.
4. Every fused kernel against the plain ``xla`` reference at those
   widths in float32, and on a 4,096-member subset against float64.
5. Fused and ``xla`` objective times (warm median of 7 runs, spread,
   compile time apart).
6. The card-only tests (``pytest -m gpu``), in this process.
7. Last line: ``{"ok": true, "device": {...}}``.

With ``--four`` the script runs only the mesh paths on four cards (a
1-D mesh of 4 and a (2, 2) mesh) and compares each with one card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 131072                 # ensemble members
T = 3651                   # daily steps (ten years)
C = 8                      # regional catchments
N_SNOW_REGIONAL = 16384    # members of the regional snow sweep
SUBSET = 4096              # members checked against float64
ALTITUDES = [250, 325, 400, 475, 550]     # elevation layers [m]
FRAC_ICE = [0.0, 0.0, 0.01, 0.03, 0.06]   # glaciated layer fractions
# The float32 contract of the fused kernels against the xla engine:
# the same model in another operation order (rsqrt(sqrt()) for **-0.25,
# pack-time reciprocals, shift registers for jnp.convolve, per-step
# accumulation for a tree reduction).
RTOL, ATOL = 5e-3, 1e-4
# Float32 against float64: float32 rounding alone flips the snow
# hysteresis branches (``th == 0`` melt switch) for some members, which
# is why the snow golden tests are float64-only.  The xla engine's own
# float32 error on the same members is printed beside the kernel's as
# the measured reason for this wider tolerance.
RTOL_F64, ATOL_F64 = 1e-2, 1e-4
TIMED_RUNS = 7


class PhaseError(RuntimeError):
    pass


def say(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


# --------------------------------------------------------------------------
# Inputs
# --------------------------------------------------------------------------

def load_basin(days=T):
    """First ``days`` days of CAMELS basin 01031500, read with numpy."""
    d = os.path.join(ROOT, "rrmpg_jax", "data", "camels")
    met_file = os.path.join(d, "01031500_lump_cida_forcing_leap.txt")
    met = np.loadtxt(met_file, skiprows=4)
    out = np.loadtxt(os.path.join(d, "01031500_05_model_output.txt"),
                     skiprows=1)
    with open(met_file) as f:
        f.readline()
        height = float(f.readline())

    def key(a):
        return a[:, 0] * 10000 + a[:, 1] * 100 + a[:, 2]

    _, i_met, i_out = np.intersect1d(key(met), key(out),
                                     return_indices=True)
    met, out = met[i_met], out[i_out]
    # Monthly climatologies (HBV-Edu) of the whole record.
    month = met[:, 1].astype(int)
    tmean = 0.5 * (met[:, 8] + met[:, 9])
    pe_m = np.array([out[month == m, 8].mean() for m in range(1, 13)])
    t_m = np.array([tmean[month == m].mean() for m in range(1, 13)])
    met, out = met[:days], out[:days]
    check(len(met) == days, f"basin has only {len(met)} joint days")
    qobs = out[:, 11].copy()
    qobs[qobs < 0] = np.nan
    tmax, tmin = met[:, 8], met[:, 9]
    month = met[:, 1].astype(int)
    tmean = 0.5 * (tmax + tmin)
    etp = out[:, 8]
    return {
        'prec': met[:, 5], 'tmax': tmax, 'tmin': tmin, 'tmean': tmean,
        'etp': etp, 'qobs': qobs, 'month': month, 'height': height,
        'pe_m': pe_m, 't_m': t_m,
    }


def regional(d):
    """``C`` catchments from the basin: scaled forcing, shifted records."""
    scale = np.linspace(0.8, 1.2, C)
    shift = [np.roll(np.arange(T), 37 * k) for k in range(C)]
    return {k: np.stack([d[k][s] * (sc if k == 'prec' else 1.0)
                         for s, sc in zip(shift, scale)])
            for k in ('prec', 'etp', 'qobs', 'tmean', 'tmin', 'tmax')}


def snow_kwargs(d):
    return dict(prec=d['prec'], mean_temp=d['tmean'], min_temp=d['tmin'],
                max_temp=d['tmax'], etp=d['etp'], frac_ice=FRAC_ICE,
                met_station_height=d['height'], altitudes=ALTITUDES)


def hbv_kwargs(d):
    return dict(temp=d['tmean'], prec=d['prec'], month=d['month'],
                PE_m=d['pe_m'], T_m=d['t_m'], snow_init=0.0,
                soil_init=100.0, s1_init=2.0, s2_init=10.0)


def param_dict(model, num, seed):
    np.random.seed(seed)
    p = model.get_random_params(num=num)
    return {k: np.asarray(p[k]) for k in p.dtype.names}


# --------------------------------------------------------------------------
# Comparison and timing
# --------------------------------------------------------------------------

def compare(name, got, want, rtol=RTOL, atol=ATOL):
    """Worst relative error of ``got`` against ``want``, with tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    check(got.shape == want.shape,
          f"{name}: shape {got.shape} != reference {want.shape}")
    both_nan = np.isnan(got) & np.isnan(want)
    check(np.array_equal(np.isfinite(got) | both_nan,
                         np.isfinite(want) | both_nan),
          f"{name}: finite entries differ from the reference")
    ok = np.isfinite(want)
    err = np.abs(got[ok] - want[ok])
    rel = err / np.maximum(np.abs(want[ok]), 1e-30)
    ratio = err / (atol + rtol * np.abs(want[ok]))
    say(f"  {name}: {ok.sum()} values, worst rel err {rel.max():.3e}, "
        f"worst err/tol {ratio.max():.3f} (rtol={rtol:g}, atol={atol:g})")
    check(ratio.max() <= 1.0, f"{name}: outside tolerance")


def timed_pair(fused, xla, runs=TIMED_RUNS):
    """Warm times of two compiled objectives, run in turns.

    Each argument is a zero-argument callable; every run ends in
    ``block_until_ready``.  Returns two sorted lists of seconds.
    """
    import jax

    jax.block_until_ready(fused())
    jax.block_until_ready(xla())
    times = ([], [])
    for _ in range(runs):
        for fn, out in ((fused, times[0]), (xla, times[1])):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            out.append(time.perf_counter() - t0)
    return sorted(times[0]), sorted(times[1])


def fmt_times(times):
    med = times[len(times) // 2]
    return (f"median {med * 1e3:.3f} ms (min {times[0] * 1e3:.3f}, "
            f"max {times[-1] * 1e3:.3f}, {len(times)} runs)")


def masked_stats(q, qo):
    """[mse, mean(q), mean(q^2), mean(q*qo)] over the finite observations
    -- the plain form of what the fused kernels accumulate."""
    import jax.numpy as jnp

    valid = jnp.isfinite(qo)
    qo0 = jnp.where(valid, qo, 0.0)
    w = valid.astype(q.dtype)
    n = jnp.sum(w)
    d = q - qo0
    return jnp.stack([jnp.sum(w * d * d), jnp.sum(w * q),
                      jnp.sum(w * q * q), jnp.sum(w * q * qo0)]) / n


def xla_objective(member_fn, params, budget_bytes):
    """The ``xla`` engine's objective over a member batch, compiled.

    ``member_fn(p)`` maps one member's parameters to a vector of
    statistics; the batch runs as a vmap over member chunks (``lax.map``)
    of the largest power-of-two width whose compiled program fits
    ``budget_bytes`` of device memory -- the member chunking of
    ``monte_carlo(batch_size=)``, inside one program.

    Returns:
        (compiled fn: params -> (K, N), chunk, compile seconds).
    """
    import jax

    n = len(next(iter(params.values())))
    chunk, t0 = n, time.perf_counter()
    while True:
        def fn(params, chunk=chunk):
            split = jax.tree.map(
                lambda x: x.reshape((n // chunk, chunk) + x.shape[1:]),
                params)
            out = jax.lax.map(jax.vmap(member_fn), split)
            return out.reshape((n,) + out.shape[2:]).T
        compiled = jax.jit(fn).lower(params).compile()
        mem = compiled.memory_analysis()
        need = (mem.temp_size_in_bytes + mem.argument_size_in_bytes
                + mem.output_size_in_bytes)
        if need <= budget_bytes or chunk <= 1024:
            return compiled, chunk, time.perf_counter() - t0
        chunk //= 2


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_device():
    import jax

    devs = jax.devices()
    dev = devs[0]
    say(f"[1] device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    if dev.platform != "gpu":
        say("[1] FAIL: JAX found no GPU; this check runs on the card only")
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"[1] card: {card}")
    return dev, len(devs), card


def phase_golden():
    """Golden trajectories in float64 on the card, as in
    tests/test_models_golden.py."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from rrmpg_jax.models import GR4J, CemaneigeHystGR4JIce

    data = os.path.join(ROOT, "tests", "data")
    prec, etp, q_excel = np.loadtxt(
        os.path.join(data, "gr4j_example_data.csv"), delimiter=",",
        skiprows=1, usecols=(1, 2, 4), unpack=True)
    gr4j = GR4J(params={'x1': np.exp(5.76865628090826),
                        'x2': np.sinh(1.61742503661094),
                        'x3': np.exp(4.24316129943456),
                        'x4': np.exp(-0.117506799276908) + 0.5})
    q = gr4j.simulate(prec, etp, s_init=0.6, r_init=0.7).flatten()
    check(q.dtype == np.float64, f"GR4J golden ran in {q.dtype}")
    check(np.allclose(q, q_excel), "GR4J differs from the Excel trajectory")
    say(f"[2] GR4J float64 vs Excel: {len(q)} days, max abs diff "
        f"{np.max(np.abs(q - q_excel)):.3e} (np.allclose)")

    cols = np.loadtxt(
        os.path.join(data, "cemaneigehystgr4jice_validation_data.csv"),
        delimiter=",", skiprows=1, usecols=(1, 2, 3, 4, 5, 6), unpack=True)
    precipitation, pe, mean_temp, max_temp, min_temp, q_ref = cols
    model = CemaneigeHystGR4JIce(params={
        "Thacc": 18.6, "Rsp": 0.22, "CTG": 0.78, "Kf": 4.02, "x1": 546,
        "x2": 0.53, "x3": 276, "x4": 1.32, "DDF": 5})
    q = model.simulate(precipitation, mean_temp, min_temp, max_temp, pe,
                       np.array([0.02, 0.04, 0.25, 0.51, 0.71]),
                       met_station_height=700,
                       altitudes=[550, 620, 700, 785, 920],
                       s_init=0.5, r_init=0.4, sca_init=0.2).flatten()
    check(np.allclose(q, q_ref),
          "CemaneigeHystGR4JIce differs from the Excel trajectory")
    say(f"[2] CemaneigeHystGR4JIce float64 vs Excel: {len(q)} days, max abs "
        f"diff {np.max(np.abs(q - q_ref)):.3e} (np.allclose)")
    jax.config.update("jax_enable_x64", False)


def model_cases(d):
    """The three fused objectives beside their ``xla`` member function,
    on the basin forcing in the current default float."""
    import jax.numpy as jnp

    from rrmpg_jax.config import default_float
    from rrmpg_jax.models import GR4J, CemaneigeHystGR4JIce, HBVEdu
    from rrmpg_jax.models.gr4j import fit_uh_lengths
    from rrmpg_jax.ops import run_cemaneigehystgr4jice, run_gr4j, run_hbvedu
    from rrmpg_jax.ops.pallas_gr4j import gr4j_ensemble_mse_pallas
    from rrmpg_jax.ops.pallas_hbv import hbv_ensemble_mse_pallas
    from rrmpg_jax.ops.pallas_snow import snowgr4j_ensemble_mse_pallas

    f = default_float()
    qobs = jnp.asarray(d['qobs'], f)
    masked = bool(np.isnan(d['qobs']).any())

    gr4j = GR4J()
    g1, g2 = fit_uh_lengths(gr4j._default_bounds['x4'][1])
    prec, etp = jnp.asarray(d['prec'], f), jnp.asarray(d['etp'], f)

    snow = CemaneigeHystGR4JIce()
    s1, s2 = fit_uh_lengths(snow._default_bounds['x4'][1])
    prepared = snow._prepare(d['prec'], d['tmean'], d['tmin'], d['tmax'],
                             d['etp'], FRAC_ICE, d['height'], ALTITUDES,
                             0, 0, 0, 0, 0)
    sp, smt, sfs, set_, sfi = (jnp.asarray(a, f) for a in prepared[:5])

    hbv = HBVEdu()
    temp, hp, month, pe_m, t_m = hbv._validate_inputs(
        d['tmean'], d['prec'], d['month'], d['pe_m'], d['t_m'])
    temp, hp, pe_m, t_m = (jnp.asarray(a, f) for a in (temp, hp, pe_m, t_m))
    month = jnp.asarray(month)
    stores = (0.0, 100.0, 2.0, 10.0)

    return [
        ('GR4J', gr4j,
         lambda p, stats: gr4j_ensemble_mse_pallas(
             prec, etp, qobs, 0.0, 0.0, p, num_uh1=g1, num_uh2=g2,
             stats=stats, masked=masked),
         lambda p: masked_stats(run_gr4j(prec, etp, 0.0, 0.0, p,
                                         num_uh1=g1, num_uh2=g2)[0], qobs)),
        ('CemaneigeHystGR4JIce', snow,
         lambda p, stats: snowgr4j_ensemble_mse_pallas(
             sp, smt, set_, sfs, qobs, 0.0, 0.0, 0.0, 0.0, p, frac_ice=sfi,
             hyst=True, ice=True, stats=stats, num_uh1=s1, num_uh2=s2,
             masked=masked),
         lambda p: masked_stats(run_cemaneigehystgr4jice(
             sp, smt, set_, sfi, sfs, 0.0, 0.0, 0.0, 0.0, 0.0, p,
             num_uh1=s1, num_uh2=s2)[0], qobs)),
        ('HBVEdu', hbv,
         lambda p, stats: hbv_ensemble_mse_pallas(
             temp, hp, month, pe_m, t_m, qobs, *stores, p, stats=stats,
             masked=masked),
         lambda p: masked_stats(run_hbvedu(temp, hp, month, pe_m, t_m,
                                           *stores, p)[0], qobs)),
    ]


def regional_snow_inputs(d, rg):
    """(C, T, L) layer forcing of the regional catchments."""
    from rrmpg_jax.models import CemaneigeHystGR4JIce

    snow = CemaneigeHystGR4JIce()
    prepared = [snow._prepare(rg['prec'][c], rg['tmean'][c], rg['tmin'][c],
                              rg['tmax'][c], rg['etp'][c], FRAC_ICE,
                              d['height'], ALTITUDES, 0, 0, 0, 0, 0)
                for c in range(C)]
    return tuple(np.stack([p[k] for p in prepared]) for k in range(4))


def phase_main(d):
    """Monte Carlo, a fused fit and both regional objectives at full width."""
    import jax.numpy as jnp

    from rrmpg_jax.models import GR4J, CemaneigeHystGR4JIce, HBVEdu
    from rrmpg_jax.parallel.regional import (regional_gr4j_objective,
                                             regional_snow_objective)
    from rrmpg_jax.tools import monte_carlo

    for name, model, kw in (
            ('GR4J', GR4J(), dict(prec=d['prec'], etp=d['etp'])),
            ('CemaneigeHystGR4JIce', CemaneigeHystGR4JIce(), snow_kwargs(d)),
            ('HBVEdu', HBVEdu(), hbv_kwargs(d))):
        np.random.seed(1)
        t0 = time.perf_counter()
        r = monte_carlo(model, N, qobs=d['qobs'], engine='pallas',
                        return_qsim=False, metrics=('mse', 'nse', 'kge'),
                        **kw)
        dt = time.perf_counter() - t0
        nse = np.asarray(r['nse'])
        finite = np.isfinite(nse)
        check(nse.shape == (N,) and finite.any(),
              f"monte_carlo {name}: no finite NSE")
        say(f"[3] monte_carlo {name}: {N} members x {T} days, "
            f"{finite.sum()} finite, best NSE {np.nanmax(nse):.4f}, "
            f"{dt:.2f} s with compilation")

    t0 = time.perf_counter()
    res = GR4J().fit(d['qobs'], d['prec'], d['etp'], engine='pallas',
                     seed=0, maxiter=3)
    check(np.isfinite(res.fun), "fused GR4J fit returned a non-finite loss")
    say(f"[3] GR4J fit (engine='pallas', 3 generations): mse {res.fun:.4f} "
        f"at x={np.round(np.asarray(res.x), 4).tolist()}, "
        f"{time.perf_counter() - t0:.2f} s with compilation")

    rg = regional(d)
    pg = {k: jnp.asarray(v) for k, v in
          param_dict(GR4J(), N, 2).items()}
    t0 = time.perf_counter()
    out_g = np.asarray(regional_gr4j_objective(
        rg['prec'], rg['etp'], rg['qobs'], 0.0, 0.0, pg))
    check(out_g.shape == (C, N) and np.isfinite(out_g).all(),
          "regional_gr4j_objective: wrong shape or non-finite losses")
    say(f"[3] regional_gr4j_objective: {C} x {N} members, "
        f"{time.perf_counter() - t0:.2f} s with compilation")

    prec_l, mt_l, fsp_l, etp_c = regional_snow_inputs(d, rg)
    ps = {k: jnp.asarray(v) for k, v in
          param_dict(CemaneigeHystGR4JIce(), N_SNOW_REGIONAL, 3).items()}
    snow_args = (prec_l, mt_l, etp_c, fsp_l, rg['qobs'], 0.0, 0.0, 0.0, 0.0,
                 ps)
    t0 = time.perf_counter()
    out_s = np.asarray(regional_snow_objective(
        *snow_args, frac_ice=FRAC_ICE, hyst=True, ice=True))
    check(out_s.shape == (C, N_SNOW_REGIONAL) and np.isfinite(out_s).all(),
          "regional_snow_objective: wrong shape or non-finite losses")
    say(f"[3] regional_snow_objective: {C} x {N_SNOW_REGIONAL} members x "
        f"{len(ALTITUDES)} layers, {time.perf_counter() - t0:.2f} s with "
        "compilation")
    return {'rg': rg, 'pg': pg, 'out_g': out_g, 'snow_args': snow_args,
            'out_s': out_s}


def phase_parity(d, main, budget):
    """Fused kernels against the ``xla`` engine, f32 and f64."""
    import jax
    import jax.numpy as jnp

    from rrmpg_jax.parallel.regional import (regional_gr4j_objective,
                                             regional_snow_objective)

    kept = []
    for i, (name, model, fused, member) in enumerate(model_cases(d)):
        p = {k: jnp.asarray(v) for k, v in
             param_dict(model, N, 10 + i).items()}
        xla_fn, chunk, compile_s = xla_objective(member, p, budget)
        ref = np.asarray(xla_fn(p))
        say(f"[4] {name}: {N} members x {T} days, xla reference in "
            f"chunks of {chunk}")
        compare(f"{name} fused mse vs xla", fused(p, False), ref[0])
        stats = np.asarray(fused(p, True))
        compare(f"{name} fused statistics vs xla", stats, ref)
        kept.append((name, fused, xla_fn, p, chunk, compile_s,
                     ref[:, :SUBSET]))

    step = 16384
    pg, rg = main['pg'], main['rg']
    ref = np.concatenate([np.asarray(regional_gr4j_objective(
        rg['prec'], rg['etp'], rg['qobs'], 0.0, 0.0,
        {k: v[i:i + step] for k, v in pg.items()}, engine='xla'))
        for i in range(0, N, step)], axis=1)
    compare(f"regional GR4J fused vs xla ({C} x {N})", main['out_g'], ref)
    step = 4096
    args = main['snow_args']
    ref = np.concatenate([np.asarray(regional_snow_objective(
        *args[:-1], {k: v[i:i + step] for k, v in args[-1].items()},
        frac_ice=FRAC_ICE, hyst=True, ice=True, engine='xla'))
        for i in range(0, N_SNOW_REGIONAL, step)], axis=1)
    compare(f"regional snow fused vs xla ({C} x {N_SNOW_REGIONAL})",
            main['out_s'], ref)

    # float64 xla reference on a subset: the f32 kernels' total error.
    fused32 = [np.asarray(k[1]({n: v[:SUBSET] for n, v in k[3].items()},
                               True)) for k in kept]
    jax.config.update("jax_enable_x64", True)
    try:
        for (name, _, _, member), k, got in zip(model_cases(d), kept,
                                                fused32):
            p64 = {n: jnp.asarray(np.asarray(v[:SUBSET]), jnp.float64)
                   for n, v in k[3].items()}
            ref64 = np.asarray(jax.jit(jax.vmap(member))(p64)).T
            compare(f"{name} xla f32 vs xla f64 ({SUBSET} members)", k[6],
                    ref64, rtol=RTOL_F64, atol=ATOL_F64)
            compare(f"{name} fused f32 vs xla f64 ({SUBSET} members)", got,
                    ref64, rtol=RTOL_F64, atol=ATOL_F64)
    finally:
        jax.config.update("jax_enable_x64", False)
    return [k[:6] for k in kept]


def phase_timing(kept, card):
    """Fused against ``xla`` objective times at full width."""
    import jax

    for name, fused, xla_fn, p, chunk, xla_compile in kept:
        t0 = time.perf_counter()
        fused_fn = jax.jit(lambda p: fused(p, True)).lower(p).compile()
        fused_compile = time.perf_counter() - t0
        t_fused, t_xla = timed_pair(lambda: fused_fn(p), lambda: xla_fn(p))
        say(f"[5] {name} objective (4 statistics), {N} members x {T} days, "
            f"{card}:")
        say(f"    fused: {fmt_times(t_fused)}; set-up (compile) "
            f"{fused_compile:.2f} s")
        say(f"    xla:   {fmt_times(t_xla)}, member chunks of {chunk}; "
            f"set-up (compile) {xla_compile:.2f} s")
        say(f"    xla / fused median: "
            f"{t_xla[len(t_xla) // 2] / t_fused[len(t_fused) // 2]:.2f}")


def phase_card_tests():
    import pytest

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "--noconftest",
                      "-m", "gpu", os.path.join(ROOT, "tests", "test_gpu.py")])
    check(rc == 0, f"card-only tests failed (pytest exit {int(rc)})")
    say("[6] card-only tests passed")


def run_one_card():
    dev, count, card = phase_device()
    from rrmpg_jax.config import enable_compile_cache

    enable_compile_cache(os.path.join(ROOT, ".jax_cache"))
    budget = 0.5 * dev.memory_stats()['bytes_limit']
    phase_golden()
    d = load_basin()
    main = phase_main(d)
    kept = phase_parity(d, main, budget)
    phase_timing(kept, card)
    phase_card_tests()
    return dev, count


def run_four_cards():
    """The mesh paths on four cards, each against one card."""
    dev, count, card = phase_device()
    check(count >= 4, f"--four needs four cards, found {count}")
    import jax
    import jax.numpy as jnp

    from rrmpg_jax.config import enable_compile_cache
    from rrmpg_jax.models import GR4J, CemaneigeHystGR4JIce
    from rrmpg_jax.parallel.mesh import default_mesh, ensemble_catchment_mesh
    from rrmpg_jax.parallel.regional import (regional_gr4j_objective,
                                             regional_snow_objective)

    enable_compile_cache(os.path.join(ROOT, ".jax_cache"))
    devs = jax.devices()[:4]
    d = load_basin()
    for engine in ('pallas', 'xla'):
        one = GR4J().fit(d['qobs'], d['prec'], d['etp'], engine=engine,
                         seed=0, maxiter=3)
        four = GR4J().fit(d['qobs'], d['prec'], d['etp'], engine=engine,
                          seed=0, maxiter=3, mesh=default_mesh(devs))
        compare(f"GR4J fit x, engine={engine}, 1-D mesh of 4 vs one card",
                four.x, one.x, rtol=1e-6, atol=0.0)
        compare(f"GR4J fit loss, engine={engine}, 1-D mesh of 4 vs one "
                "card", [four.fun], [one.fun], rtol=1e-6, atol=0.0)

    rg = regional(d)
    pg = {k: jnp.asarray(v) for k, v in param_dict(GR4J(), N, 2).items()}
    ps = {k: jnp.asarray(v) for k, v in
          param_dict(CemaneigeHystGR4JIce(), N_SNOW_REGIONAL, 3).items()}
    prec_l, mt_l, fsp_l, etp_c = regional_snow_inputs(d, rg)
    snow_args = (prec_l, mt_l, etp_c, fsp_l, rg['qobs'], 0.0, 0.0, 0.0, 0.0,
                 ps)
    snow_kw = dict(frac_ice=FRAC_ICE, hyst=True, ice=True)
    ref_g = np.asarray(regional_gr4j_objective(
        rg['prec'], rg['etp'], rg['qobs'], 0.0, 0.0, pg))
    ref_s = np.asarray(regional_snow_objective(*snow_args, **snow_kw))
    for shape in ((4, 1), (2, 2)):
        mesh = ensemble_catchment_mesh(ensemble=shape[0],
                                       catchment=shape[1], devices=devs)
        got = regional_gr4j_objective(rg['prec'], rg['etp'], rg['qobs'],
                                      0.0, 0.0, pg, mesh=mesh)
        check(len(got.sharding.device_set) == 4,
              "regional GR4J result is not spread over four cards")
        compare(f"regional GR4J fused, mesh {shape} vs one card "
                f"({C} x {N})", got, ref_g, rtol=1e-6, atol=0.0)
        got = regional_snow_objective(*snow_args, mesh=mesh, **snow_kw)
        compare(f"regional snow fused, mesh {shape} vs one card "
                f"({C} x {N_SNOW_REGIONAL})", got, ref_s, rtol=1e-6,
                atol=0.0)
    return dev, count


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run the mesh paths on four cards only")
    args = parser.parse_args()
    try:
        dev, count = run_four_cards() if args.four else run_one_card()
    except PhaseError as err:
        say(f"FAIL: {err}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
