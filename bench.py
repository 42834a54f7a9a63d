"""Benchmark: the SCF programs on the GPU, at the configurations the
smoke run (chip_smoke.py) also uses.

1. Ar HF  (BASELINE config 2): SCF wall-clock to 1 uEh convergence.
2. N2 PBE (BASELINE config 5): prolate-spheroidal two-center FEM,
   sigma+pi basis (lmax = 6 per |m|), PBE via the JAX-native functionals.
Plus heavier profile points: Xe HF (lmax=3), N2 HF at the REFERENCE-
CONVERGED discretization (lmax=12 per |m|), and gensap Kr.

Prints the headline JSON line {"metric", "value", "unit", "vs_baseline",
"device", ...} AS SOON AS the two headline configs finish. value = Ar-HF
SCF seconds + N2-PBE SCF seconds; the "profile" dict holds the per-phase
breakdown (host setup / TEI tables, compile, SCF wall, per-iteration,
eigensolve probe, achieved GFLOP/s and GB/s of the Fock build from XLA
cost analysis). Every wall ends in jax.block_until_ready.

The heavier profile points (Xe, gensap Kr, reference-converged N2 lmax=12)
run AFTER the headline print and only while a wall-clock budget remains
(HELFEM_BENCH_BUDGET_S, default 1080 s measured from process start); each
has a cost estimate and is skipped -- recorded as such -- when it would not
fit. If any extras ran, ONE enriched JSON line (same metric/value, wider
profile) is printed at the end.

vs_baseline: the reference OpenMP binary cannot be built in this image
(no Fortran compiler, no Armadillo headers, no GSL -- see BASELINE.md), so
the baseline is THIS REPO'S OWN f64 CPU path at identical
discretizations (constants below, see BASELINE.md for the command).
vs_baseline = CPU seconds / GPU seconds (>1 means the GPU wins).

Energy gates: Ar/Xe vs numerical HF limits; N2 PBE vs this repo's own CPU
run of the identical discretization -- a mismatch > 1 uEh fails the metric
(value = inf). Refuses to run without a GPU; exits non-zero after printing
when a headline config fails.
"""

import json
import os
import subprocess
import sys
import time

import jax

_T0 = time.monotonic()  # process start: the budget clock
BUDGET_S = float(os.environ.get("HELFEM_BENCH_BUDGET_S", "1080"))

jax.config.update("jax_enable_x64", True)

AR_HF_LIMIT = -526.8175128  # numerical HF limit (Saito 2009)
# N2 PBE at lmax=(6,6), nelem=5, nnodes=8, Rmax=25, Rbond=2.0743: this
# repo's CPU f64 converged value; a device run must stay within 1 uEh.
N2_PBE_CPU = -108.978708437276
XE_HF_LIMIT = -7232.1383638  # Cinal 2020, J. Math. Chem. 58, 1571
# N2 HF limit (Kobus 1993 / x2dhf) AT ITS QUOTED GEOMETRY R = 2.068 a0:
# the gate for the reference-converged lmax=12, nnodes=15 discretization
# (radial truncation < 1e-5 there; the angular error at lmax=12 is ~8 uEh,
# measured: lmax 12 -> 14 moves E by 8.0e-6, 14 -> 16 by 9e-8). NOTE the
# PBE profile point uses the experimental R = 2.0743 and is gated against
# this repo's own CPU f64 at the same R; comparing R = 2.0743 against the
# R = 2.068 limit costs ~7.1e-4 Eh of pure geometry (measured) and is why
# the converged-N2 point pins R = 2.068.
N2_HF_LIMIT = -108.9938255
N2_HF_RBOND = 2.068

# This repo's own f64 CPU wall-clock at the IDENTICAL bench configs
# (JAX_PLATFORMS=cpu, warm jit, 2026-08-17/18 on the host CPU of the
# image it was measured in; scripts in BASELINE.md). The baseline for
# vs_baseline given the unbuildable reference binary.
CPU_F64 = {
    # re-measured after each exchange rewrite; where repeat measurements
    # differ by noise the SMALLER (faster-CPU) number is recorded
    "ar_hf": 1.342,
    "n2_pbe": 0.975,
    "xe_hf_lmax3": 4.433,
    "gensap_kr": 0.276,
    # reference-converged N2 (lmax=12, nnodes=15, rmax=40, R=2.068):
    # warm SCF 382.2 s / 8 iters / 47.8 s per iteration (setup 12.8 s),
    # E = -108.99381787 = HF limit - 7.6 uEh
    "n2_hf_lmax12": 382.2,
}


def _cost_analysis(fn, *args):
    """(flops, bytes_accessed) of jitted fn from XLA cost analysis of the
    LOWERED (pre-compile) HLO, or (None, None) when unavailable.

    Deliberately no .compile(): compiling a probe costs as much as compiling
    the SCF path it mirrors, only to read FLOP counters. Lowered-HLO
    analysis costs milliseconds and the einsum FLOP counts are identical."""
    try:
        ca = jax.jit(fn).lower(*args).cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        fl = float(ca.get("flops", 0.0))
        by = float(ca.get("bytes accessed", 0.0))
        return (fl if fl > 0 else None), (by if by > 0 else None)
    except Exception:
        return None, None


def _rates(out, flops, nbytes):
    """Attach Fock-build cost + achieved per-iteration rates to a profile."""
    if flops:
        out["fock_gflop"] = round(flops / 1e9, 3)
        out["achieved_gflops"] = round(flops / 1e9 / out["per_iter_s"], 2)
    if nbytes:
        out["fock_gb"] = round(nbytes / 1e9, 3)
        out["achieved_gbs"] = round(nbytes / 1e9 / out["per_iter_s"], 2)
    return out


def bench_ar():
    import jax.numpy as jnp
    import numpy as np

    from helfem_tpu.models.atomic import (
        AtomicBasis, channel_diag, coulomb, exchange, exchange_bd,
    )
    from helfem_tpu.scf.atomic_scf import scf_atom

    basis = AtomicBasis(Z=18, lmax=1, mmax=1, rmax=40.0, nelem=10, nnodes=15)
    t0 = time.perf_counter()
    ops = basis.build_operators()  # host setup: radial TEI tables etc.
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    scf_atom(basis, 9, 9, convthr=1e-9, maxit=5, ops=ops)  # compile warmup
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = scf_atom(basis, 9, 9, convthr=1e-9, maxit=60, ops=ops)
    scf_s = time.perf_counter() - t0

    # eigensolve probe: one blocked generalized eigh on the converged Fock
    from helfem_tpu.utils.linalg import eig_gsym_lm

    Pa = jnp.zeros((basis.nbf, basis.nbf))
    F = ops.H0 + coulomb(ops, Pa) + exchange(ops, Pa)
    jax.block_until_ready(eig_gsym_lm(F, ops.Sinvh_rad))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(eig_gsym_lm(F, ops.Sinvh_rad))
    eigh_s = time.perf_counter() - t0

    # iterative-eigensolver probe (--eigiter path): lowest 10 eigenpairs
    # per block via host shift-invert ARPACK, incl. device->host transfer.
    # Data point for when the iterative option beats the dense batched eigh.
    from helfem_tpu.utils.linalg import build_blocks, eig_blocks_iter

    bi, bs = build_blocks(np.asarray(ops.S), basis.sym_blocks(2))
    t0 = time.perf_counter()
    eig_blocks_iter(np.asarray(F), bi, bs, 10, -0.6 * 18**2 - 10.0)
    eigiter_s = time.perf_counter() - t0

    # cost of the ACTUAL SCF hot path: J + block-diagonal-density exchange
    # (the (l,m)-symmetry-block SCF never builds the dense channel-pair K)
    flops, nbytes = _cost_analysis(
        lambda P: coulomb(ops, P)
        + exchange_bd(ops, channel_diag(P, basis.nang, basis.nrad)),
        Pa,
    )

    ok = res.converged and abs(res.E - AR_HF_LIMIT) < 1e-6
    return _rates({
        "ok": bool(ok),
        "scf_s": round(scf_s, 3),
        "setup_s": round(setup_s, 3),
        "compile_s": round(compile_s, 3),
        "iterations": res.niter,
        "per_iter_s": round(scf_s / max(res.niter, 1), 4),
        "eigh_probe_s": round(eigh_s, 4),
        "eigiter_probe_s": round(eigiter_s, 4),
        "energy": res.E,
        "energy_err_vs_hf_limit": res.E - AR_HF_LIMIT,
        "converged": bool(res.converged),
    }, flops, nbytes)


def bench_n2():
    import jax.numpy as jnp

    from helfem_tpu.models.diatomic import DiatomicBasis, coulomb_dia
    from helfem_tpu.scf.diatomic_scf import scf_diatomic

    basis = DiatomicBasis(
        Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0, nelem=5, nnodes=8
    )
    t0 = time.perf_counter()
    ops = basis.build_operators()  # host setup incl. channel-batched TEI tables
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    scf_diatomic(basis, 7, 7, method="PBE", convthr=1e-7, maxit=4, ops=ops)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = scf_diatomic(basis, 7, 7, method="PBE", convthr=1e-7, maxit=60, ops=ops)
    scf_s = time.perf_counter() - t0

    # PBE has no exact exchange: the executed Fock build is J + grid XC.
    # Cost the Coulomb build only (round 4 costed the dense exchange_dia,
    # a path the PBE SCF never runs).
    Pa = jnp.zeros((basis.nbf, basis.nbf))
    flops, nbytes = _cost_analysis(lambda P: coulomb_dia(ops, P), Pa)

    ok = res.converged and (
        N2_PBE_CPU is None or abs(res.E - N2_PBE_CPU) < 1e-6
    )
    out = _rates({
        "ok": bool(ok),
        "scf_s": round(scf_s, 3),
        "setup_s": round(setup_s, 3),
        "compile_s": round(compile_s, 3),
        "iterations": res.niter,
        "per_iter_s": round(scf_s / max(res.niter, 1), 4),
        "energy": res.E,
        "converged": bool(res.converged),
    }, flops, nbytes)
    if N2_PBE_CPU is not None:
        out["energy_err_vs_cpu_f64"] = res.E - N2_PBE_CPU
    return out


def bench_xe():
    """Heavier atomic profile point: Xe HF with an empty f channel
    (lmax=3) -- 4x the symmetry blocks and Z=54 vs the Ar headline."""
    import jax.numpy as jnp

    from helfem_tpu.models.atomic import (
        AtomicBasis, channel_diag, coulomb, exchange_bd,
    )
    from helfem_tpu.scf.atomic_scf import scf_atom

    basis = AtomicBasis(Z=54, lmax=3, mmax=3, rmax=40.0, nelem=8, nnodes=12, zexp=2.5)
    t0 = time.perf_counter()
    ops = basis.build_operators()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scf_atom(basis, 27, 27, convthr=1e-8, maxit=4, ops=ops)  # compile warmup
    compile_s = time.perf_counter() - t0
    # convthr 3e-8 (Ar runs at 1e-9); the energy is gated to 3e-6 below
    t0 = time.perf_counter()
    res = scf_atom(basis, 27, 27, convthr=3e-8, maxit=50, ops=ops)
    scf_s = time.perf_counter() - t0

    Pa = jnp.zeros((basis.nbf, basis.nbf))
    flops, nbytes = _cost_analysis(
        lambda P: coulomb(ops, P)
        + exchange_bd(ops, channel_diag(P, basis.nang, basis.nrad)),
        Pa,
    )
    return _rates({
        "ok": bool(res.converged and abs(res.E - XE_HF_LIMIT) < 3e-6),
        "scf_s": round(scf_s, 3),
        "setup_s": round(setup_s, 3),
        "compile_s": round(compile_s, 3),
        "iterations": res.niter,
        "per_iter_s": round(scf_s / max(res.niter, 1), 4),
        "energy": res.E,
        "energy_err_vs_hf_limit": res.E - XE_HF_LIMIT,
        "converged": bool(res.converged),
    }, flops, nbytes)


def bench_n2_converged():
    """N2 HF at the reference-converged discretization (lmax=12 per |m|,
    the config the reference program was built for): the step-chunked
    exchange is the enabler -- the flat (channel, bra-shell) scan is
    ~7000 sequential steps without it."""
    from helfem_tpu.models.diatomic import DiatomicBasis
    from helfem_tpu.scf.diatomic_scf import scf_diatomic

    basis = DiatomicBasis(
        Z1=7, Z2=7, Rbond=N2_HF_RBOND, lmax=(12, 12, 12), rmax=40.0, nelem=5,
        nnodes=15,
    )
    t0 = time.perf_counter()
    ops = basis.build_operators()
    setup_s = time.perf_counter() - t0
    # warmup maxit=4: two host iterations plus the first fused on-device
    # chunk, so every kernel the real run uses (incl. the chunk and its
    # warm eigensolve) is compiled -- or served from the persistent cache
    # -- before the timed run. This bills ~2 real fused iterations as
    # "compile"; the alternative (maxit=1) leaves the chunk compile inside
    # the timed scf_s.
    t0 = time.perf_counter()
    scf_diatomic(basis, 7, 7, method="HF", convthr=1e-7, maxit=4, ops=ops,
                 guess="SAP")
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = scf_diatomic(basis, 7, 7, method="HF", convthr=1e-7, maxit=40, ops=ops,
                       guess="SAP")
    scf_s = time.perf_counter() - t0
    return {
        "ok": bool(res.converged and abs(res.E - N2_HF_LIMIT) < 2e-5),
        "scf_s": round(scf_s, 3),
        "setup_s": round(setup_s, 3),
        "compile_s": round(compile_s, 3),
        "iterations": res.niter,
        "per_iter_s": round(scf_s / max(res.niter, 1), 4),
        "energy": res.E,
        "energy_err_vs_hf_limit": res.E - N2_HF_LIMIT,
        "converged": bool(res.converged),
    }


def bench_gensap():
    """BASELINE config 3: spherically-averaged atom + SAP-potential
    generation (gensap) for Kr. The first solve pays the fused-chunk
    compile; the warm repeat is the user-facing cost."""
    import numpy as np

    from helfem_tpu.models.sadatom import SadAtomBasis, coulomb_screening, solve_sadatom

    basis = SadAtomBasis(Z=36, lmax=2, rmax=40.0, nelem=8, nnodes=12)
    t0 = time.perf_counter()
    solve_sadatom(basis, method="SVWN", convthr=1e-7, search=False)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve_sadatom(basis, method="SVWN", convthr=1e-7, search=False)
    jax.block_until_ready(res.orbs)
    scf_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Zeff = coulomb_screening(basis, np.asarray(res.Pl).sum(axis=0))  # SAP export
    sap_s = time.perf_counter() - t0
    # closed-shell Kr: the spherically-averaged LSD atom equals full LSD;
    # NIST "Atomic Reference Data" gives -2750.147940
    ok = (
        res.converged
        and abs(res.E + 2750.147940) < 1e-5
        and np.all(np.isfinite(np.asarray(Zeff)))
    )
    return {
        "ok": bool(ok),
        "scf_s": round(scf_s, 3),
        "compile_s": round(cold_s - scf_s, 3),
        "sap_export_s": round(sap_s, 3),
        "energy": res.E,
        "converged": bool(res.converged),
    }


def _guard(fn):
    """One failing profile point must not kill the whole bench line: the
    error is recorded once, with no retry."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - report, don't crash
        return {"ok": False, "error": f"{type(e).__name__}: {e}"[:300]}


def device_info() -> dict:
    """The JAX device and the cards' nvidia-smi name and power limit."""
    dev = jax.devices()[0]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = None
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}


def _emit(profile, device):
    """Assemble and print the metric JSON line from whatever profile
    entries exist so far (headline = Ar + N2 PBE); returns whether the
    headline configs passed."""
    ar, n2 = profile["ar_hf"], profile["n2_pbe"]
    ok = ar.get("ok", False) and n2.get("ok", False)
    value = ar["scf_s"] + n2["scf_s"] if ok else float("inf")
    # per-config CPU-f64 comparison where measured
    for key, cpu_s in CPU_F64.items():
        if cpu_s and key in profile and profile[key].get("scf_s"):
            profile[key]["cpu_f64_s"] = cpu_s
            profile[key]["vs_cpu_f64"] = round(cpu_s / profile[key]["scf_s"], 3)
    cpu_headline = (CPU_F64["ar_hf"] or 0) + (CPU_F64["n2_pbe"] or 0)
    vsb = round(cpu_headline / value, 3) if (ok and cpu_headline) else 1.0
    print(
        json.dumps(
            {
                "metric": "ar_hf_plus_n2_pbe_scf_wall_clock_1uEh",
                "value": round(value, 3) if ok else value,
                "unit": "s",
                "vs_baseline": vsb,
                "device": device,
                "budget_used_s": round(time.monotonic() - _T0, 1),
                "profile": profile,
            }
        ),
        flush=True,
    )
    return ok


def main() -> int:
    if jax.default_backend() != "gpu":
        print(f"bench: needs a GPU, JAX backend is {jax.default_backend()!r}",
              file=sys.stderr, flush=True)
        return 1
    device = device_info()
    profile = {"ar_hf": _guard(bench_ar), "n2_pbe": _guard(bench_n2)}
    # the headline is printed the moment the two headline configs finish
    ok = _emit(profile, device)

    # heavier profile points, best-effort within the remaining budget; a
    # config that would not fit its estimate (compile walls included) is
    # recorded as skipped, not attempted
    extras = [
        ("xe_hf_lmax3", bench_xe, 180.0),
        ("gensap_kr", bench_gensap, 60.0),
        ("n2_hf_lmax12", bench_n2_converged, 150.0),
    ]
    for key, fn, est_s in extras:
        remaining = BUDGET_S - (time.monotonic() - _T0)
        if remaining < est_s:
            profile[key] = {"ok": None, "skipped": True,
                            "reason": f"budget: {remaining:.0f}s left < {est_s:.0f}s estimate"}
            continue
        profile[key] = _guard(fn)
    # enriched line (same metric/value, extras or skip records added); a
    # kill mid-extras still leaves the earlier headline line as the tail
    _emit(profile, device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
