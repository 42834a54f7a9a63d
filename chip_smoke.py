"""Smoke run of the SCF programs on NVIDIA GPUs.

Runs the four deployments that bench.py defines, through the library entry
points (scf_atom, scf_diatomic, solve_sadatom), at their full sizes, in ONE
process (a JAX process reserves most of the card's memory when it starts):

  ar_hf         Ar HF, lmax=1, 10 elements x 15 nodes, convthr 1e-9
  n2_pbe        N2 PBE, lmax=(6,6), 5 x 8, convthr 1e-7
  gensap_kr     spherically averaged Kr SVWN (the SAP generator)
  n2_hf_lmax12  N2 HF at the reference-converged discretization
                (lmax=(12,12,12), 5 x 15, rmax=40; nbf 4130)

Each phase prints one line: energy, iterations, convergence, set-up, first
call (compile + the first iterations) and SCF walls, its energy gate, and
the device's peak_bytes_in_use so far. Eigensolver lines compare the raw
device eigh and utils.linalg.eigh_refined with LAPACK on the converged
whitened Fock blocks (Ar and N2 lmax=12). The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

and it is printed only when every gate passed.

    python chip_smoke.py          # the four phases on one GPU
    python chip_smoke.py --four   # on four GPUs: the sharded SCF (ndev=4)
                                  # for ar_hf and n2_pbe against ndev=0,
                                  # and the multi-device dry run

Exits non-zero without the JSON line on any JAX backend but the GPU, on a
failed gate and on any exception.
"""

import argparse
import json
import os
import platform
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

AR_HF_LIMIT = -526.8175128  # numerical HF limit (Saito 2009)
N2_PBE_CPU = -108.978708437276  # this repo's CPU f64 run, same discretization
KR_SVWN = -2750.147940  # NIST Atomic Reference Data, LSD
N2_HF_LIMIT = -108.9938255  # Kobus / x2dhf, R = 2.068
N2_HF_LMAX12_CPU = -108.99381787  # this repo's CPU f64 run, same discretization

# basis keyword arguments of each phase (bench.py's configurations)
CONFIGS = {
    "ar_hf": dict(Z=18, lmax=1, mmax=1, rmax=40.0, nelem=10, nnodes=15),
    "n2_pbe": dict(Z1=7, Z2=7, Rbond=2.0743, lmax=(6, 6), rmax=25.0,
                   nelem=5, nnodes=8),
    "gensap_kr": dict(Z=36, lmax=2, rmax=40.0, nelem=8, nnodes=12),
    "n2_hf_lmax12": dict(Z1=7, Z2=7, Rbond=2.068, lmax=(12, 12, 12),
                         rmax=40.0, nelem=5, nnodes=15),
}
EIG_TOL_E = 1e-9  # Eh, occupied levels against LAPACK
EIG_TOL_RES = 1e-12  # max_b ||A V - V E||_F / ||A||_F


def _emit(tag: str, rec: dict) -> None:
    print(f"[{tag}] {json.dumps(rec, default=float)}", flush=True)


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _gate(rec: dict, name: str, value: float, tol: float) -> None:
    ok = bool(np.isfinite(value) and abs(value) < tol)
    rec[name] = value
    rec[name + "_tol"] = tol
    rec[name + "_pass"] = ok
    rec.setdefault("failed", [])
    if not ok:
        rec["failed"].append(name)


def _check_f64(rec: dict, **arrays) -> None:
    bad = {k: str(np.asarray(a).dtype) for k, a in arrays.items()
           if np.asarray(a).dtype != np.float64}
    rec["dtypes_f64"] = not bad
    if bad:
        rec.setdefault("failed", []).append(f"dtype {bad}")


def _timed(fn, sync=lambda out: out):
    """(fn(), wall seconds), the wall ending in jax.block_until_ready on
    sync(out) -- the arrays a result holds."""
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(sync(out))
    return out, time.perf_counter() - t0


def _orbs(res):
    return res.orbs_a


def _finish(rec: dict) -> dict:
    rec["peak_bytes_in_use"] = _peak_bytes()
    rec["pass"] = not rec.get("failed")
    return rec


# ---------------------------------------------------------------- phases


def phase_ar_hf():
    import jax.numpy as jnp

    from helfem_tpu.models.atomic import AtomicBasis
    from helfem_tpu.scf.atomic_scf import make_fock, scf_atom
    from helfem_tpu.utils.linalg import build_blocks, density_blocks

    basis = AtomicBasis(**CONFIGS["ar_hf"])
    ops, setup_s = _timed(basis.build_operators)
    _, first_s = _timed(lambda: scf_atom(basis, 9, 9, convthr=1e-9, maxit=5,
                                         ops=ops), _orbs)
    res, scf_s = _timed(lambda: scf_atom(basis, 9, 9, convthr=1e-9, maxit=60,
                                         ops=ops), _orbs)
    rec = dict(name="ar_hf", E=res.E, niter=res.niter,
               converged=bool(res.converged), setup_s=setup_s,
               first_call_s=first_s, scf_s=scf_s)
    if not res.converged:
        rec.setdefault("failed", []).append("converged")
    _gate(rec, "E_minus_hf_limit", res.E - AR_HF_LIMIT, 1e-6)

    # converged Fock in whitened symmetry-block coordinates
    bi, bs = build_blocks(np.asarray(ops.S), basis.sym_blocks(2))
    P = density_blocks(jnp.asarray(res.orbs_a), jnp.asarray(res.occ_a),
                       jnp.asarray(bi), ops.S)
    fock = make_fock((), 1.0, basis.nrad, restricted=True, bd=True)
    F = fock(ops, None, jnp.zeros_like(ops.S), None, P, P)[0]
    _check_f64(rec, fock=F, orbitals=res.orbs_a)
    Forth = _whiten(np.asarray(F), bi, bs)
    return _finish(rec), (Forth, np.asarray(res.occ_a))


def phase_n2_pbe():
    from helfem_tpu.models.diatomic import DiatomicBasis
    from helfem_tpu.scf.diatomic_scf import scf_diatomic

    basis = DiatomicBasis(**CONFIGS["n2_pbe"])
    ops, setup_s = _timed(basis.build_operators)
    _, first_s = _timed(lambda: scf_diatomic(
        basis, 7, 7, method="PBE", convthr=1e-7, maxit=4, ops=ops), _orbs)
    res, scf_s = _dia_scf(basis, ops, "PBE", "core", 60)
    rec = dict(name="n2_pbe", E=res.E, niter=res.niter,
               converged=bool(res.converged), setup_s=setup_s,
               first_call_s=first_s, scf_s=scf_s)
    if not res.converged:
        rec.setdefault("failed", []).append("converged")
    _gate(rec, "E_minus_cpu_f64", res.E - N2_PBE_CPU, 1e-6)
    F = _dia_fock(basis, ops, res, "PBE")
    _check_f64(rec, fock=F, orbitals=res.orbs_a)
    return _finish(rec), None


def phase_gensap_kr():
    import jax.numpy as jnp

    from helfem_tpu.models.sadatom import (SadAtomBasis, coulomb_screening,
                                           make_sad_fock, solve_sadatom)
    from helfem_tpu.ops.xc import parse_method

    basis = SadAtomBasis(**CONFIGS["gensap_kr"])
    ops, setup_s = _timed(basis.build_ops)

    def solve():
        return solve_sadatom(basis, method="SVWN", convthr=1e-7,
                             search=False, ops=ops)

    _, first_s = _timed(solve, lambda r: r.orbs)
    res, scf_s = _timed(solve, lambda r: r.orbs)
    Zeff = coulomb_screening(basis, np.asarray(res.Pl).sum(axis=0))
    rec = dict(name="gensap_kr", E=res.E, converged=bool(res.converged),
               setup_s=setup_s, first_call_s=first_s, scf_s=scf_s,
               zeff_finite=bool(np.all(np.isfinite(Zeff))))
    if not res.converged:
        rec.setdefault("failed", []).append("converged")
    if not rec["zeff_finite"]:
        rec.setdefault("failed", []).append("zeff_finite")
    _gate(rec, "E_minus_nist", res.E - KR_SVWN, 1e-5)
    funcs, _ = parse_method("SVWN")
    Pl = jnp.asarray(res.Pl)
    fock = make_sad_fock(tuple(funcs), 0.0, Pl.shape[0], basis.nrad)
    F = fock(ops, 0.5 * Pl, 0.5 * Pl, None, None)[0]
    _check_f64(rec, fock=F, orbitals=res.orbs)
    return _finish(rec), None


def phase_n2_hf_lmax12():
    from helfem_tpu.models.diatomic import DiatomicBasis
    from helfem_tpu.scf.diatomic_scf import (eig_blocks_dia_b,
                                             gather_blocks_dia, scf_diatomic)

    basis = DiatomicBasis(**CONFIGS["n2_hf_lmax12"])
    ops, setup_s = _timed(basis.build_operators)
    print(f"n2_hf_lmax12: nbf {basis.nbf}, blocks "
          f"{tuple(ops.blk_idx.shape)}, setup {setup_s:.1f} s", flush=True)
    # warm-up: two host iterations plus the first fused device chunk, so
    # the timed run below compiles nothing
    _, first_s = _timed(lambda: scf_diatomic(
        basis, 7, 7, method="HF", convthr=1e-7, maxit=4, ops=ops,
        guess="SAP"), _orbs)
    res, scf_s = _dia_scf(basis, ops, "HF", "SAP", 40)
    rec = dict(name="n2_hf_lmax12", nbf=basis.nbf, E=res.E, niter=res.niter,
               converged=bool(res.converged), setup_s=setup_s,
               first_call_s=first_s, scf_s=scf_s,
               E_minus_cpu_f64=res.E - N2_HF_LMAX12_CPU)
    if not res.converged:
        rec.setdefault("failed", []).append("converged")
    _gate(rec, "E_minus_hf_limit", res.E - N2_HF_LIMIT, 2e-5)
    F = _dia_fock(basis, ops, res, "HF")
    _check_f64(rec, fock=F, orbitals=res.orbs_a)
    # the SCF's own whole-batch device eigensolve, compiled once more to
    # read its memory plan
    Fb = gather_blocks_dia(ops, F)
    ma = eig_blocks_dia_b.lower(ops, Fb).compile().memory_analysis()
    print("n2_hf_lmax12: eig_blocks_dia_b memory_analysis: "
          + _mem_str(ma), flush=True)
    Forth = _whiten(np.asarray(F), np.asarray(ops.blk_idx),
                    np.asarray(ops.blk_sinvh))
    return _finish(rec), (Forth, np.asarray(res.occ_a))


def _mem_str(ma) -> str:
    if ma is None:
        return "unavailable"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return json.dumps({k: getattr(ma, k, None) for k in keys})


def _dia_scf(basis, ops, method, guess, maxit):
    from helfem_tpu.scf.diatomic_scf import scf_diatomic

    return _timed(lambda: scf_diatomic(basis, 7, 7, method=method,
                                       convthr=1e-7, maxit=maxit, ops=ops,
                                       guess=guess), _orbs)


def _dia_fock(basis, ops, res, method):
    """Converged restricted Fock matrix, rebuilt by the SCF's own builder."""
    import jax.numpy as jnp

    from helfem_tpu.models.diatomic_dft import build_dia_grid
    from helfem_tpu.ops.xc import parse_method
    from helfem_tpu.scf.diatomic_scf import (density_dia, make_dia_fock,
                                             occ_select, occupied_dia)

    funcs, kfrac = parse_method(method)
    g = build_dia_grid(basis) if funcs else None
    C = jnp.asarray(res.orbs_a)
    P = density_dia(ops, C, jnp.asarray(res.occ_a))
    Co = None
    if kfrac != 0.0:
        sel = occ_select(res.occ_a, int((res.occ_a > 0).sum()))
        Co = occupied_dia(ops, C, sel)
    fock = make_dia_fock(tuple(funcs), kfrac, restricted=True,
                         njbd=getattr(basis, "njbd", None))
    return fock(ops, g, P, P, Co, Co)[0]


def _whiten(F: np.ndarray, bi: np.ndarray, bs: np.ndarray) -> np.ndarray:
    """Whitened symmetry blocks exactly as the SCF eigensolves them (padded
    slots carry the SCF's never-occupied eigenvalue)."""
    from helfem_tpu.utils.linalg import _BIG

    nbf = F.shape[0]
    Fp = np.pad(F, ((0, 1), (0, 1)))
    Fb = Fp[bi[:, :, None], bi[:, None, :]]
    Forth = np.einsum("bpi,bpq,bqj->bij", bs, Fb, bs, optimize=True)
    pad = (bi == nbf).astype(F.dtype)
    return Forth + _BIG * np.eye(bi.shape[1])[None] * pad[:, None, :]


def eig_check(name: str, Forth: np.ndarray, occ: np.ndarray) -> dict:
    """Raw device eigh and eigh_refined against LAPACK on the same blocks:
    max |dE| over the occupied levels and max_b ||A V - V E||_F / ||A||_F."""
    import jax
    import jax.numpy as jnp

    from helfem_tpu.utils.linalg import eigh_refined

    E_ref = np.linalg.eigh(Forth)[0]
    A = jnp.asarray(Forth)
    rec = dict(name=f"eig_{name}", shape=list(Forth.shape))
    normA = np.linalg.norm(Forth, axis=(1, 2))
    occm = occ > 0
    for label, fn in (("raw_eigh", jnp.linalg.eigh), ("eigh_refined", eigh_refined)):
        jf = jax.jit(fn)
        jax.block_until_ready(jf(A))
        (E, V), secs = _timed(lambda: jf(A))
        E, V = np.asarray(E), np.asarray(V)
        res = np.linalg.norm(Forth @ V - V * E[:, None, :], axis=(1, 2)) / normA
        rec[f"{label}_s"] = secs
        _gate(rec, f"{label}_occ_dE", float(np.abs(E - E_ref)[occm].max()), EIG_TOL_E)
        _gate(rec, f"{label}_rel_residual", float(res.max()), EIG_TOL_RES)
    return _finish(rec)


# ---------------------------------------------------------------- --four


def four_card_checks():
    import jax

    from helfem_tpu.models.atomic import AtomicBasis
    from helfem_tpu.models.diatomic import DiatomicBasis
    from helfem_tpu.scf.atomic_scf import scf_atom
    from helfem_tpu.scf.diatomic_scf import scf_diatomic

    recs = []
    ab = AtomicBasis(**CONFIGS["ar_hf"])
    aops = ab.build_operators()
    db = DiatomicBasis(**CONFIGS["n2_pbe"])
    dops = db.build_operators()
    runs = (
        ("ar_hf", lambda n: scf_atom(ab, 9, 9, convthr=1e-9, maxit=60,
                                     ops=aops, ndev=n)),
        ("n2_pbe", lambda n: scf_diatomic(db, 7, 7, method="PBE",
                                          convthr=1e-7, maxit=60, ops=dops,
                                          ndev=n)),
    )
    for name, run in runs:
        # ndev=0 is the one-device program (fused device chunks after two
        # host iterations); ndev=1 runs the same mesh host loop as ndev=4
        # on one card, so it fixes the iteration count to compare against
        r = {}
        walls = {}
        for n in (0, 1, 4):
            r[n], walls[n] = _timed(lambda: run(n), _orbs)
        rec = dict(name=f"{name}_ndev4", E_ndev0=r[0].E, E_ndev1=r[1].E,
                   E_ndev4=r[4].E, niter_ndev0=r[0].niter,
                   niter_ndev1=r[1].niter, niter_ndev4=r[4].niter,
                   converged=all(x.converged for x in r.values()),
                   first_call_s=walls)
        _gate(rec, "E_ndev4_minus_ndev0", r[4].E - r[0].E, 1e-9)
        _gate(rec, "E_ndev4_minus_ndev1", r[4].E - r[1].E, 1e-9)
        if r[1].niter != r[4].niter:
            rec["failed"].append("niter")
        if not rec["converged"]:
            rec["failed"].append("converged")
        recs.append(_finish(rec))
        _emit("four", recs[-1])

    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__._dryrun_impl(4)
    rec = _finish(dict(name="dryrun_impl_4", wall_s=time.perf_counter() - t0,
                       devices=len(jax.devices())))
    _emit("four", rec)
    recs.append(rec)
    return recs


# ---------------------------------------------------------------- main


def _print_env() -> None:
    import jax

    from bench import device_info

    info = device_info()
    print(f"jax {jax.__version__} devices: {jax.devices()}", flush=True)
    print(f"device_kind: {info['kind']}  count: {info['count']}", flush=True)
    for line in (info["nvidia_smi"] or "unavailable").splitlines():
        print(f"nvidia-smi: {line}", flush=True)
    print(f"host: {platform.machine()}  {np.finfo(np.longdouble)}".replace(
        "\n", " "), flush=True)
    cache = (jax.config.jax_compilation_cache_dir
             if jax.config.jax_enable_compilation_cache else None)
    print(f"compile cache: {cache}", flush=True)


def _build_native() -> None:
    """Rebuild the native host library from source (never load a .so built
    on another host); its seconds are set-up time."""
    csrc = os.path.join(HERE, "csrc")
    so = os.path.join(csrc, "libhelfem_tei.so")
    if os.path.exists(so):
        os.remove(so)  # a failed build must not leave an old library behind
    t0 = time.perf_counter()
    proc = subprocess.run(["make", "-C", csrc, "-B"], capture_output=True,
                          text=True)
    secs = time.perf_counter() - t0
    from helfem_tpu.utils import native

    lib = native.get_lib()
    print(f"native host library: make rc={proc.returncode} in {secs:.1f} s, "
          f"loaded={lib is not None}", flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-2000:], file=sys.stderr, flush=True)


def run_phases() -> list:
    """The one-card phases and their eigensolver checks; returns records."""
    recs = []
    for fn in (phase_ar_hf, phase_n2_pbe, phase_gensap_kr, phase_n2_hf_lmax12):
        t0 = time.perf_counter()
        try:
            rec, eig_in = fn()
        except Exception:  # noqa: BLE001 - report, then fail the run
            traceback.print_exc()
            rec, eig_in = dict(name=fn.__name__[6:], failed=["exception"],
                               **{"pass": False}), None
        rec["phase_wall_s"] = time.perf_counter() - t0
        _emit("phase", rec)
        recs.append(rec)
        if eig_in is not None:
            try:
                erec = eig_check(rec["name"], *eig_in)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                erec = dict(name=f"eig_{rec['name']}", failed=["exception"],
                            **{"pass": False})
            _emit("eig", erec)
            recs.append(erec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded SCF checks only")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import jax

    import helfem_tpu  # noqa: F401 - enables x64 and the compile cache

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU, JAX backend is {backend!r}",
              file=sys.stderr, flush=True)
        return 1
    need = 4 if args.four else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, found {len(jax.devices())}",
              file=sys.stderr, flush=True)
        return 1
    _print_env()
    _build_native()
    recs = four_card_checks() if args.four else run_phases()
    wall = time.perf_counter() - t_start
    failed = [r["name"] for r in recs if not r.get("pass")]
    print(f"total wall {wall:.1f} s; failed: {failed or 'none'}", flush=True)
    if failed:
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
