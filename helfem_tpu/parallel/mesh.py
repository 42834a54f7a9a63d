"""Multi-device sharding layer (the JAX replacement for the reference's
OpenMP parallel regions, SURVEY.md section 2.7).

The reference's parallelism sites map onto a 1D device mesh as follows:

| reference OpenMP site                      | mesh sharding here                 |
|--------------------------------------------|------------------------------------|
| exchange: collapse(2) over channel pairs   | L-channel axis sharded over 'ch'   |
| compute_tei over (L, element)              | TEI tensors sharded on the L axis  |
| per-element matrix assembly                | element-local einsums (no comm)    |
| eig per symmetry block (serial LAPACK)     | symmetry blocks sharded over 'ch'  |
| grid-energy reductions (omp reduction)     | jax.lax.psum over 'ch'             |

One SCF iteration = shard_map(fock_shard) [L-sharded J/K, psum] followed by
shard_map(eig_shard) [block-sharded batched eigh, all_gather]. The 1D 'ch'
mesh follows the algorithm, not a device topology, so it suits cards joined
all to all (NVLink); XLA hands the collectives to NCCL on the GPU.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from helfem_tpu.models.atomic import (AtomicOperators, channel_diag, coulomb,
                                      exchange, exchange_bd)
from helfem_tpu.scf.diatomic_scf import _BIG as _DIA_BIG
from helfem_tpu.utils.linalg import eigh_refined

__all__ = ["make_mesh", "pad_ops_for_mesh", "sharded_scf_step",
           "sharded_dia_fock", "sharded_xc_fock", "pad_grid_for_mesh",
           "sharded_dia_eig", "sharded_dia_xc", "pad_dia_grid_for_mesh",
           "sharded_sad_exchange", "sharded_eig_blocks",
           "sharded_atomic_fock", "sharded_dia_scf_fock"]


def make_mesh(n_devices: int, backend: str | None = None) -> Mesh:
    """1D 'ch' mesh over exactly n_devices devices.

    Raises if the chosen backend exposes fewer than n_devices devices rather
    than silently building a smaller mesh. Pass backend="cpu" with
    XLA_FLAGS=--xla_force_host_platform_device_count=N to test sharding
    without real chips (the conftest.py recipe)."""
    devs = jax.devices(backend) if backend else jax.devices()
    if len(devs) < n_devices:
        raise RuntimeError(
            f"make_mesh: need {n_devices} devices, backend "
            f"{backend or jax.default_backend()!r} has {len(devs)}. "
            "For a virtual mesh set JAX_PLATFORMS=cpu and "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n_devices}."
        )
    return Mesh(np.array(devs[:n_devices]), ("ch",))


def pad_ops_for_mesh(ops: AtomicOperators, n: int) -> AtomicOperators:
    """Pad the L axis of the TEI/Gaunt tensors to a multiple of n with zeros
    (zero channels contribute nothing to J/K)."""
    NL = ops.G.shape[0]
    pad = (-NL) % n
    if pad == 0:
        return ops
    padL = lambda x: jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    return ops._replace(
        G=padL(ops.G),
        Lfac=padL(ops.Lfac),
        tei=padL(ops.tei),
        disjL=padL(ops.disjL),
        disjm1L=padL(ops.disjm1L),
    )


def sharded_scf_step(mesh: Mesh, ops: AtomicOperators, kfrac: float = 1.0,
                     bd: bool = False):
    """Returns a jitted step(Pa, Pb) -> (Fa, E_blocks, C_blocks, energies)
    running one SCF iteration sharded over the mesh.

    The L axis of (G, Lfac, tei, disjL, disjm1L) is sharded over 'ch'; the
    density is replicated; partial J/K are psum'ed. The symmetry-block
    eigensolve shards the (padded) angular-block axis over 'ch' and
    all-gathers the spectra.

    bd=True uses the block-diagonal-density collapsed exchange (the actual
    SCF hot path under (l,m) symmetry blocks, models.atomic.exchange_bd):
    each device evaluates the radial kernels of its L shard on the
    channel-diagonal density blocks and the Gaunt-weighted partial K is
    psum'ed exactly like the dense path.
    """
    n = mesh.devices.size
    ops = pad_ops_for_mesh(ops, n)
    nrad = ops.Sinvh_rad.shape[0]
    nang = ops.G.shape[-1]
    nblk = -(-nang // n) * n  # angular blocks padded for the eigh shard

    lspec = AtomicOperators(
        gidx=P(),
        G=P("ch"),
        Lfac=P("ch"),
        tei=P("ch"),
        disjL=P("ch"),
        disjm1L=P("ch"),
        S=P(),
        H0=P(),
        T=P(),
        Vnuc=P(),
        Sinvh_rad=P(),
    )

    def fock_shard(ops_l, Pa, Pb):
        # each device holds an L-shard; J/K partials psum over 'ch'
        P_ = Pa + Pb
        J = jax.lax.psum(coulomb(ops_l, P_), "ch")
        if bd:
            K_of = lambda Ps: exchange_bd(ops_l, channel_diag(Ps, nang, nrad))
        else:
            K_of = lambda Ps: exchange(ops_l, Ps)
        Ka = kfrac * jax.lax.psum(K_of(Pa), "ch")
        Kb = kfrac * jax.lax.psum(K_of(Pb), "ch")
        Fa = ops_l.H0 + J + Ka
        Fb = ops_l.H0 + J + Kb
        Ekin = jnp.vdot(P_, ops_l.T)
        Ecoul = 0.5 * jnp.vdot(P_, J)
        Exx = 0.5 * (jnp.vdot(Pa, Ka) + jnp.vdot(Pb, Kb))
        return Fa, Fb, Ekin, Ecoul, Exx

    def eig_shard(F, Sinvh_rad):
        # block-shard the batched whitened eigensolve over 'ch'
        i = jax.lax.axis_index("ch")
        per = nblk // n
        Fb = jnp.stack(
            [
                jax.lax.dynamic_slice(
                    jnp.pad(F, ((0, nblk * nrad - nang * nrad), (0, nblk * nrad - nang * nrad)))
                    + jnp.diag(
                        jnp.arange(nblk * nrad) >= nang * nrad
                    ).astype(F.dtype),
                    ((i * per + k) * nrad, (i * per + k) * nrad),
                    (nrad, nrad),
                )
                for k in range(per)
            ]
        )
        Forth = jnp.einsum("pi,apq,qj->aij", Sinvh_rad, Fb, Sinvh_rad)
        E, V = eigh_refined(Forth)
        C = jnp.einsum("pi,aij->apj", Sinvh_rad, V)
        E = jax.lax.all_gather(E, "ch", axis=0, tiled=True)
        C = jax.lax.all_gather(C, "ch", axis=0, tiled=True)
        return E[:nang], C[:nang]

    fock_sm = jax.shard_map(
        fock_shard,
        mesh=mesh,
        in_specs=(lspec, P(), P()),
        out_specs=(P(), P(), P(), P(), P()),
        check_vma=False,
    )
    eig_sm = jax.shard_map(
        eig_shard,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(Pa, Pb):
        Fa, Fb, Ekin, Ecoul, Exx = fock_sm(ops, Pa, Pb)
        Ea, Ca = eig_sm(Fa, ops.Sinvh_rad)
        Eb, Cb = eig_sm(Fb, ops.Sinvh_rad)
        Enuc = jnp.vdot(Pa + Pb, ops.Vnuc)
        return Fa, Fb, Ea, Ca, Eb, Cb, Ekin + Enuc + Ecoul + Exx

    return step, ops


def sharded_eig_blocks(mesh: Mesh, blk_idx, blk_sinvh, nbf: int):
    """Generic blocked whitened eigensolve with the (padded) symmetry-block
    axis sharded over 'ch' and the spectra all-gathered -- the multi-chip
    form of utils.linalg.eig_blocks (same _BIG padded-slot convention; the
    reference analog is the per-block LAPACK loop of scf::eig_gsym_sub,
    src/general/scf_helpers.cpp:142-162, whose blocks OpenMP'd BLAS handled
    serially). Returns a jitted eig(F) -> (E [nblk, blen], C)."""
    n = mesh.devices.size
    blk_idx = jnp.asarray(blk_idx)
    blk_sinvh = jnp.asarray(blk_sinvh)
    nblk, blen = blk_idx.shape
    pad = (-nblk) % n
    blk_idx_p = jnp.concatenate(
        [blk_idx, jnp.full((pad, blen), nbf, blk_idx.dtype)]
    )
    blk_sinvh_p = jnp.pad(blk_sinvh, ((0, pad), (0, 0), (0, 0)))
    per = (nblk + pad) // n

    def eig_shard(F):
        i = jax.lax.axis_index("ch")
        bi = jax.lax.dynamic_slice_in_dim(blk_idx_p, i * per, per, 0)
        bs = jax.lax.dynamic_slice_in_dim(blk_sinvh_p, i * per, per, 0)
        Fp = jnp.pad(F, ((0, 1), (0, 1)))
        Fb = Fp[bi[:, :, None], bi[:, None, :]]
        Forth = jnp.einsum("bpi,bpq,bqj->bij", bs, Fb, bs)
        padm = (bi == nbf).astype(F.dtype)
        Forth = Forth + _DIA_BIG * jnp.eye(blen)[None] * padm[:, None, :]
        E, V = eigh_refined(Forth)
        C = jnp.einsum("bpi,bij->bpj", bs, V)
        E = jax.lax.all_gather(E, "ch", axis=0, tiled=True)
        C = jax.lax.all_gather(C, "ch", axis=0, tiled=True)
        return E[:nblk], C[:nblk]

    eig_sm = jax.shard_map(
        eig_shard, mesh=mesh, in_specs=(P(),), out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(eig_sm)


def sharded_atomic_fock(mesh: Mesh, ops: AtomicOperators, funcs=(), g=None,
                        kfrac: float = 0.0, nrad: int = 0, bd: bool = True,
                        Bz: float = 0.0, dftthr: float = 1e-12,
                        restricted: bool = False):
    """Full atomic Fock build (J + K + XC + fields + energies) sharded over
    the mesh in ONE shard_map dispatch: the L axis of the TEI/Gaunt tensors
    is sharded over 'ch' (J/K partials psum), the radial-element axis of
    the DFT grid is sharded over 'ch' (XC partials psum -- the reference
    DFTGrid's OpenMP even/odd element sweep, src/atomic/dftgrid.cpp:817-870).

    Returns (fock_fn, ops_padded, g_padded) where fock_fn(Vextra, Pa, Pb)
    has the same 9-tuple contract as scf.atomic_scf.make_fock's fock()
    (minus the ops/g/rs leading args, closed over here), so the SCF host
    loop can swap it in directly (the --ndev driver path)."""
    from helfem_tpu.models.atomic_dft import DFTGridOps, eval_fxc

    n = mesh.devices.size
    ops = pad_ops_for_mesh(ops, n)
    nang = ops.G.shape[-1]
    if funcs:
        g = pad_grid_for_mesh(g, nrad, n)
        gspec = DFTGridOps(
            bg=P("ch"), dbg=P("ch"), r=P("ch"), w2=P("ch"),
            wth=P(), TT=P(), dTT=P(), dTT2=P(), TTm2=P(),
            gidx=P("ch"), d2bg=P("ch"), LTT=P(),
        )
    else:
        gspec = P()

    lspec = AtomicOperators(
        gidx=P(), G=P("ch"), Lfac=P("ch"), tei=P("ch"),
        disjL=P("ch"), disjm1L=P("ch"),
        S=P(), H0=P(), T=P(), Vnuc=P(), Sinvh_rad=P(),
    )

    def fock_shard(ops_l, g_l, Vextra, Pa, Pb):
        Ptot = Pa + Pb
        J = jax.lax.psum(coulomb(ops_l, Ptot), "ch")
        H = ops_l.H0 + Vextra
        Fa = H + J
        Fb = H + J
        Exx = 0.0
        if kfrac != 0.0:
            if bd:
                K_of = lambda Ps: exchange_bd(ops_l, channel_diag(Ps, nang, nrad))
            else:
                K_of = lambda Ps: exchange(ops_l, Ps)
            Ka = kfrac * jax.lax.psum(K_of(Pa), "ch")
            Kb = Ka if restricted else kfrac * jax.lax.psum(K_of(Pb), "ch")
            Fa = Fa + Ka
            Fb = Fb + Kb
            Exx = 0.5 * (jnp.vdot(Pa, Ka) + jnp.vdot(Pb, Kb))
        Exc = 0.0
        Nel = 0.0
        if funcs:
            XCa, XCb, Exc, Nel = eval_fxc(funcs, g_l, Pa, Pb, nrad, dftthr)
            Fa = Fa + jax.lax.psum(XCa, "ch")
            Fb = Fb + jax.lax.psum(XCb, "ch")
            Exc = jax.lax.psum(Exc, "ch")
            Nel = jax.lax.psum(Nel, "ch")
        if Bz != 0.0:
            Fa = Fa - 0.5 * Bz * ops_l.S
            Fb = Fb + 0.5 * Bz * ops_l.S
        Ekin = jnp.vdot(Ptot, ops_l.T)
        Enuc = jnp.vdot(Ptot, ops_l.Vnuc)
        Efield = jnp.vdot(Ptot, Vextra)
        Ecoul = 0.5 * jnp.vdot(Ptot, J)
        return Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel, Efield

    fock_sm = jax.shard_map(
        fock_shard,
        mesh=mesh,
        in_specs=(lspec, gspec, P(), P(), P()),
        out_specs=tuple(P() for _ in range(9)),
        check_vma=False,
    )
    return jax.jit(lambda Vextra, Pa, Pb: fock_sm(ops, g, Vextra, Pa, Pb)), ops, g


def pad_grid_for_mesh(g, nrad: int, n: int):
    """Pad the radial-element axis of a DFTGridOps to a multiple of n.
    Padded elements carry zero quadrature weight, r = 1 (no division by
    zero in the gradient terms), and trash-slot gidx (they gather zero
    density and scatter into the dropped row) -- they contribute exactly
    nothing."""
    nelem = g.r.shape[0]
    pad = (-nelem) % n
    if pad == 0:
        return g

    def padz(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    return g._replace(
        bg=padz(g.bg),
        dbg=padz(g.dbg),
        d2bg=padz(g.d2bg),
        r=jnp.concatenate([g.r, jnp.ones((pad,) + g.r.shape[1:])]),
        w2=padz(g.w2),
        gidx=jnp.concatenate(
            [g.gidx, jnp.full((pad,) + g.gidx.shape[1:], nrad, g.gidx.dtype)]
        ),
    )


def sharded_xc_fock(mesh: Mesh, g, funcs, nrad: int, thr: float = 1e-12):
    """XC Fock build sharded over the radial-element axis of the quadrature
    grid: the device replacement for the reference DFTGrid's
    OpenMP-over-elements loop with even/odd write sweeps
    (src/atomic/dftgrid.cpp:817-870) -- each device integrates its element
    shard and the partial Fxc / Exc / Nel are psum'ed (overlapping FEM rows
    sum correctly, which is exactly the race the even/odd sweep avoided).

    Returns (xc_fn, g_padded) with xc_fn(Pa, Pb) -> (Fxca, Fxcb, Exc, Nel).
    """
    from helfem_tpu.models.atomic_dft import DFTGridOps, eval_fxc

    n = mesh.devices.size
    g = pad_grid_for_mesh(g, nrad, n)
    espec = DFTGridOps(
        bg=P("ch"), dbg=P("ch"), r=P("ch"), w2=P("ch"),
        wth=P(), TT=P(), dTT=P(), dTT2=P(), TTm2=P(),
        gidx=P("ch"), d2bg=P("ch"), LTT=P(),
    )

    def xc_shard(g_l, Pa, Pb):
        Fa, Fb, Exc, Nel = eval_fxc(funcs, g_l, Pa, Pb, nrad, thr)
        return (
            jax.lax.psum(Fa, "ch"),
            jax.lax.psum(Fb, "ch"),
            jax.lax.psum(Exc, "ch"),
            jax.lax.psum(Nel, "ch"),
        )

    xc_sm = jax.shard_map(
        xc_shard,
        mesh=mesh,
        in_specs=(espec, P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(lambda Pa, Pb: xc_sm(g, Pa, Pb)), g


def sharded_dia_fock(mesh: Mesh, ops, kfrac: float = 1.0):
    """Diatomic Fock build sharded over the (L,M) channel axes: each device
    scans its shard of the signed-LM channels (J) / of the (L,|M|) exchange
    channels (K, bra-shell axis dense per channel); partial J/K psum over
    'ch'.

    The radial TEI tables stay replicated (they are indexed dynamically by
    channel inside the scans); returns (fock_fn, ops_padded)."""
    from helfem_tpu.models.diatomic import DiatomicOperators, coulomb_dia, exchange_dia

    n = mesh.devices.size

    def padn(x, axis=0):
        pad = (-x.shape[axis]) % n
        if pad == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return jnp.pad(x, widths)

    # pad the sharded step axes. An explicit all-zero Gaunt channel is
    # appended first, and padded exchange steps point their signed-channel
    # lookups (step_sp/step_sm) at it so they contribute exactly nothing.
    nLM = ops.GmLM.shape[0]
    zrow = jnp.zeros((1,) + ops.GmLM.shape[1:])
    GmLM = jnp.concatenate([ops.GmLM, zrow])
    GpLM = jnp.concatenate([ops.GpLM, zrow])
    LM_ilm = jnp.concatenate([ops.LM_ilm, jnp.zeros(1, ops.LM_ilm.dtype)])
    zch = nLM  # index of the zero channel
    nsteps = ops.step_ilm.shape[0]
    pad_steps = (-nsteps) % n
    ops = ops._replace(
        GmLM=padn(GmLM),
        GpLM=padn(GpLM),
        LM_ilm=padn(LM_ilm),
        step_ilm=padn(ops.step_ilm),
        step_sp=jnp.concatenate(
            [ops.step_sp, jnp.full(pad_steps, zch, ops.step_sp.dtype)]
        ),
        step_sm=jnp.concatenate(
            [ops.step_sm, jnp.full(pad_steps, zch, ops.step_sm.dtype)]
        ),
        step_wm=padn(ops.step_wm),
    )

    nLMp = ops.GmLM.shape[0]
    nstepp = ops.step_ilm.shape[0]
    lm_chunk = nLMp // n
    st_chunk = nstepp // n

    def fock_shard(ops_r, Pa, Pb):
        # All tables are replicated; each device slices its chunk of the
        # J channel scan and the K step scan (the exchange channel lookups
        # step_sp/step_sm index the FULL GmLM table, so it must stay whole).
        i = jax.lax.axis_index("ch")

        def sl(x, chunk):
            return jax.lax.dynamic_slice_in_dim(x, i * chunk, chunk, axis=0)

        ops_j = ops_r._replace(
            GmLM=sl(ops_r.GmLM, lm_chunk),
            GpLM=sl(ops_r.GpLM, lm_chunk),
            LM_ilm=sl(ops_r.LM_ilm, lm_chunk),
        )
        ops_k = ops_r._replace(
            step_ilm=sl(ops_r.step_ilm, st_chunk),
            step_sp=sl(ops_r.step_sp, st_chunk),
            step_sm=sl(ops_r.step_sm, st_chunk),
            step_wm=sl(ops_r.step_wm, st_chunk),
        )
        Ptot = Pa + Pb
        J = jax.lax.psum(coulomb_dia(ops_j, Ptot), "ch")
        Ka = kfrac * jax.lax.psum(exchange_dia(ops_k, Pa), "ch")
        Kb = kfrac * jax.lax.psum(exchange_dia(ops_k, Pb), "ch")
        Fa = ops_r.H0 + J + Ka
        Fb = ops_r.H0 + J + Kb
        return Fa, Fb, 0.5 * jnp.vdot(Ptot, J), 0.5 * (jnp.vdot(Pa, Ka) + jnp.vdot(Pb, Kb))

    fock_sm = jax.shard_map(
        fock_shard,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), ops), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(lambda Pa, Pb: fock_sm(ops, Pa, Pb)), ops


def sharded_dia_exchange_occ(mesh: Mesh, ops, no: int):
    """Occupied-orbital factorized diatomic exchange K(Co) with the
    (L,|M|) channel step axis sharded over 'ch' -- the multi-chip form of
    the SCF path at scale (exchange_dia_occ). Every post-scan transform in
    exchange_dia_occ (window assembly, triangle symmetrization, shell
    mask, sign) is linear in the channel contributions, so psum of the
    per-shard results is exact. Padded steps point their signed-channel
    lookups at an appended all-zero Gaunt row (exact no-ops), as in
    sharded_dia_fock. Returns (jitted K(Co [nbf, no]), nothing shared)."""
    from helfem_tpu.models.diatomic import exchange_dia_occ

    n = mesh.devices.size

    # append the zero Gaunt channel and pad the step axis to n
    nLM = ops.GmLM.shape[0]
    zrow = jnp.zeros((1,) + ops.GmLM.shape[1:])
    nsteps = ops.step_ilm.shape[0]
    pad_steps = (-nsteps) % n
    ops = ops._replace(
        GmLM=jnp.concatenate([ops.GmLM, zrow]),
        GpLM=jnp.concatenate([ops.GpLM, zrow]),
        LM_ilm=jnp.concatenate([ops.LM_ilm, jnp.zeros(1, ops.LM_ilm.dtype)]),
        step_ilm=jnp.pad(ops.step_ilm, (0, pad_steps)),
        step_sp=jnp.concatenate(
            [ops.step_sp, jnp.full(pad_steps, nLM, ops.step_sp.dtype)]
        ),
        step_sm=jnp.concatenate(
            [ops.step_sm, jnp.full(pad_steps, nLM, ops.step_sm.dtype)]
        ),
        step_wm=jnp.pad(ops.step_wm, (0, pad_steps)),
    )
    st_chunk = ops.step_ilm.shape[0] // n

    def k_shard(ops_r, Co):
        i = jax.lax.axis_index("ch")

        def sl(x):
            return jax.lax.dynamic_slice_in_dim(x, i * st_chunk, st_chunk, axis=0)

        ops_k = ops_r._replace(
            step_ilm=sl(ops_r.step_ilm), step_sp=sl(ops_r.step_sp),
            step_sm=sl(ops_r.step_sm), step_wm=sl(ops_r.step_wm),
        )
        return jax.lax.psum(exchange_dia_occ(ops_k, Co), "ch")

    k_sm = jax.shard_map(
        k_shard,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), ops), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(lambda Co: k_sm(ops, Co))


def sharded_dia_eig(mesh: Mesh, ops):
    """Diatomic blocked whitened eigensolve with the (padded) symmetry-block
    axis sharded over 'ch' and the spectra all-gathered -- the multi-chip
    form of scf.diatomic_scf.eig_blocks_dia (same _BIG padded-slot
    convention). Returns a jitted eig(F) -> (E [nblk, blen], C)."""
    n = mesh.devices.size
    nblk, blen = ops.blk_idx.shape
    nbf = ops.S.shape[0]
    pad = (-nblk) % n
    blk_idx = jnp.concatenate(
        [ops.blk_idx, jnp.full((pad, blen), nbf, ops.blk_idx.dtype)]
    )
    blk_sinvh = jnp.pad(ops.blk_sinvh, ((0, pad), (0, 0), (0, 0)))
    per = (nblk + pad) // n

    def eig_shard(F):
        i = jax.lax.axis_index("ch")
        bi = jax.lax.dynamic_slice_in_dim(blk_idx, i * per, per, 0)
        bs = jax.lax.dynamic_slice_in_dim(blk_sinvh, i * per, per, 0)
        Fp = jnp.pad(F, ((0, 1), (0, 1)))
        Fb = Fp[bi[:, :, None], bi[:, None, :]]
        Forth = jnp.einsum("bpi,bpq,bqj->bij", bs, Fb, bs)
        padm = (bi == nbf).astype(F.dtype)
        Forth = Forth + _DIA_BIG * jnp.eye(blen)[None] * padm[:, None, :]
        E, V = eigh_refined(Forth)
        C = jnp.einsum("bpi,bij->bpj", bs, V)
        E = jax.lax.all_gather(E, "ch", axis=0, tiled=True)
        C = jax.lax.all_gather(C, "ch", axis=0, tiled=True)
        return E[:nblk], C[:nblk]

    eig_sm = jax.shard_map(
        eig_shard, mesh=mesh, in_specs=(P(),), out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(eig_sm)


def pad_dia_grid_for_mesh(g, nrad: int, n: int):
    """Pad the mu-element axis of a DiaGridOps to a multiple of n. Padded
    elements carry zero basis values and weights, benign (=1) geometric
    factors, and trash-slot gidx -- they contribute exactly nothing."""
    nelem = g.Bg.shape[0]
    pad = (-nelem) % n
    if pad == 0:
        return g

    def padz(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    def pad1(x):
        return jnp.concatenate([x, jnp.ones((pad,) + x.shape[1:])])

    return g._replace(
        Bg=padz(g.Bg), dBg=padz(g.dBg), d2Bg=padz(g.d2Bg),
        w=padz(g.w), invh=pad1(g.invh), invhphi2=pad1(g.invhphi2),
        coth=pad1(g.coth), inv_sh2=pad1(g.inv_sh2),
        gidx=jnp.concatenate(
            [g.gidx, jnp.full((pad,) + g.gidx.shape[1:], nrad, g.gidx.dtype)]
        ),
    )


def sharded_dia_xc(mesh: Mesh, g, funcs, ops, thr: float = 1e-12):
    """Diatomic XC Fock build sharded over the mu-element axis of the 2D
    quadrature grid (the two-center analogue of sharded_xc_fock; reference:
    the diatomic DFTGrid OpenMP element loop). Returns (xc_fn, g_padded)
    with xc_fn(Pa, Pb) -> (Fxca, Fxcb, Exc, Nel)."""
    from helfem_tpu.models.diatomic_dft import DiaGridOps, eval_fxc_dia

    n = mesh.devices.size
    nrad = int(ops.shellmask.shape[-1])
    g = pad_dia_grid_for_mesh(g, nrad, n)
    espec = DiaGridOps(
        Bg=P("ch"), dBg=P("ch"), w=P("ch"), invh=P("ch"),
        TT=P(), dTT=P(), dTT2=P(), TTm2=P(), invhphi2=P("ch"),
        sqeta=P(), gidx=P("ch"), d2Bg=P("ch"), coth=P("ch"),
        inv_sh2=P("ch"), LLTT=P(), TTmm=P(),
    )

    def xc_shard(g_l, ops_r, Pa, Pb):
        Fa, Fb, Exc, Nel = eval_fxc_dia(funcs, g_l, ops_r, Pa, Pb, thr)
        return (
            jax.lax.psum(Fa, "ch"),
            jax.lax.psum(Fb, "ch"),
            jax.lax.psum(Exc, "ch"),
            jax.lax.psum(Nel, "ch"),
        )

    xc_sm = jax.shard_map(
        xc_shard,
        mesh=mesh,
        in_specs=(espec, jax.tree.map(lambda _: P(), ops), P(), P()),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(lambda Pa, Pb: xc_sm(g, ops, Pa, Pb)), g


def sharded_dia_scf_fock(mesh: Mesh, ops, funcs=(), g=None, kfrac: float = 0.0,
                         dftthr: float = 1e-12, restricted: bool = False):
    """Full diatomic Fock build sharded over the mesh in ONE shard_map
    dispatch, with the same contract as scf.diatomic_scf.make_dia_fock's
    fock() (minus the leading ops/g args): fock_fn(Pa, Pb, Coa, Cob) ->
    (Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel). Sharding (the --ndev
    driver path):

    - Coulomb: signed-(L,M) channel scan axis sharded over 'ch' (reference:
      the omp-for over (L,M) disjoint integrals, src/diatomic/basis.cpp:1175).
    - exchange: (L,|M|) step axis sharded over 'ch', occupied-factorized
      K(Co) when Co columns are supplied (the SCF hot path), dense K(P)
      otherwise (reference: omp collapse(2), src/diatomic/basis.cpp:1560).
    - XC: mu-element axis of the 2D grid sharded over 'ch'.
    All partials psum; padded channels/steps point at an appended all-zero
    Gaunt row (exact no-ops)."""
    from helfem_tpu.models.diatomic import (coulomb_dia, exchange_dia,
                                            exchange_dia_occ)
    from helfem_tpu.models.diatomic_dft import DiaGridOps, eval_fxc_dia

    n = mesh.devices.size

    # pad the sharded axes (zero Gaunt channel trick, see sharded_dia_fock)
    nLM = ops.GmLM.shape[0]
    zrow = jnp.zeros((1,) + ops.GmLM.shape[1:])
    nsteps = ops.step_ilm.shape[0]
    pad_steps = (-nsteps) % n

    def padn(x, axis=0):
        pad = (-x.shape[axis]) % n
        if pad == 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return jnp.pad(x, widths)

    ops = ops._replace(
        GmLM=padn(jnp.concatenate([ops.GmLM, zrow])),
        GpLM=padn(jnp.concatenate([ops.GpLM, zrow])),
        LM_ilm=padn(jnp.concatenate([ops.LM_ilm, jnp.zeros(1, ops.LM_ilm.dtype)])),
        step_ilm=padn(ops.step_ilm),
        step_sp=jnp.concatenate(
            [ops.step_sp, jnp.full(pad_steps, nLM, ops.step_sp.dtype)]
        ),
        step_sm=jnp.concatenate(
            [ops.step_sm, jnp.full(pad_steps, nLM, ops.step_sm.dtype)]
        ),
        step_wm=padn(ops.step_wm),
    )
    lm_chunk = ops.GmLM.shape[0] // n
    st_chunk = ops.step_ilm.shape[0] // n

    if funcs:
        nrad = int(ops.shellmask.shape[-1])
        g = pad_dia_grid_for_mesh(g, nrad, n)
        gspec = DiaGridOps(
            Bg=P("ch"), dBg=P("ch"), w=P("ch"), invh=P("ch"),
            TT=P(), dTT=P(), dTT2=P(), TTm2=P(), invhphi2=P("ch"),
            sqeta=P(), gidx=P("ch"), d2Bg=P("ch"), coth=P("ch"),
            inv_sh2=P("ch"), LLTT=P(), TTmm=P(),
        )
    else:
        gspec = P()

    def make(fock_shard, nout, has_occ):
        in_specs = (jax.tree.map(lambda _: P(), ops), gspec, P(), P())
        if has_occ:
            in_specs = in_specs + (P(), P())
        return jax.shard_map(
            fock_shard, mesh=mesh, in_specs=in_specs,
            out_specs=tuple(P() for _ in range(nout)), check_vma=False,
        )

    def body(ops_r, g_l, Pa, Pb, Ka, Kb):
        """Everything but the exchange partials (already psum'ed)."""
        Ptot = Pa + Pb
        i = jax.lax.axis_index("ch")

        def sl(x, chunk):
            return jax.lax.dynamic_slice_in_dim(x, i * chunk, chunk, axis=0)

        ops_j = ops_r._replace(
            GmLM=sl(ops_r.GmLM, lm_chunk),
            GpLM=sl(ops_r.GpLM, lm_chunk),
            LM_ilm=sl(ops_r.LM_ilm, lm_chunk),
        )
        J = jax.lax.psum(coulomb_dia(ops_j, Ptot), "ch")
        Fa = ops_r.H0 + J + Ka
        Fb = ops_r.H0 + J + Kb
        Exx = 0.5 * (jnp.vdot(Pa, Ka) + jnp.vdot(Pb, Kb))
        Exc = 0.0
        Nel = 0.0
        if funcs:
            XCa, XCb, Exc, Nel = eval_fxc_dia(funcs, g_l, ops_r, Pa, Pb, dftthr)
            Fa = Fa + jax.lax.psum(XCa, "ch")
            Fb = Fb + jax.lax.psum(XCb, "ch")
            Exc = jax.lax.psum(Exc, "ch")
            Nel = jax.lax.psum(Nel, "ch")
        Ekin = jnp.vdot(Ptot, ops_r.T)
        Enuc = jnp.vdot(Ptot, ops_r.Vnuc)
        Ecoul = 0.5 * jnp.vdot(Ptot, J)
        return Fa, Fb, Ekin, Enuc, Ecoul, Exx, Exc, Nel

    def k_ops(ops_r):
        i = jax.lax.axis_index("ch")

        def sl(x):
            return jax.lax.dynamic_slice_in_dim(x, i * st_chunk, st_chunk, axis=0)

        return ops_r._replace(
            step_ilm=sl(ops_r.step_ilm), step_sp=sl(ops_r.step_sp),
            step_sm=sl(ops_r.step_sm), step_wm=sl(ops_r.step_wm),
        )

    def fock_dense(ops_r, g_l, Pa, Pb):
        Ka = Kb = jnp.zeros_like(Pa)
        if kfrac != 0.0:
            ops_k = k_ops(ops_r)
            Ka = kfrac * jax.lax.psum(exchange_dia(ops_k, Pa), "ch")
            Kb = (Ka if restricted
                  else kfrac * jax.lax.psum(exchange_dia(ops_k, Pb), "ch"))
        return body(ops_r, g_l, Pa, Pb, Ka, Kb)

    def fock_occ(ops_r, g_l, Pa, Pb, Coa, Cob):
        ops_k = k_ops(ops_r)
        Ka = kfrac * jax.lax.psum(exchange_dia_occ(ops_k, Coa), "ch")
        Kb = (Ka if restricted
              else kfrac * jax.lax.psum(exchange_dia_occ(ops_k, Cob), "ch"))
        return body(ops_r, g_l, Pa, Pb, Ka, Kb)

    dense_sm = make(fock_dense, 8, has_occ=False)
    occ_sm = make(fock_occ, 8, has_occ=True) if kfrac != 0.0 else None
    dense_jit = jax.jit(lambda Pa, Pb: dense_sm(ops, g, Pa, Pb))
    occ_jit = (jax.jit(lambda Pa, Pb, Coa, Cob: occ_sm(ops, g, Pa, Pb, Coa, Cob))
               if occ_sm is not None else None)

    def fock_fn(Pa, Pb, Coa=None, Cob=None):
        if kfrac != 0.0 and Coa is not None and (restricted or Cob is not None):
            return occ_jit(Pa, Pb, Coa, Coa if Cob is None else Cob)
        return dense_jit(Pa, Pb)

    return fock_fn, ops, g


def sharded_sad_exchange(mesh: Mesh, ops):
    """Sadatom l-resolved exchange with the L-channel axis of the radial
    TEI tables sharded over 'ch' and the K partials psum'ed (the sadatom
    analogue of the atomic L-shard; reference: the OpenMP loop in
    src/sadatom/basis.cpp:360-460). Returns a jitted K(Pang)."""
    from helfem_tpu.models.atomic import exchange_kernel_L

    n = mesh.devices.size
    NL = ops.at.tei.shape[0]
    pad = (-NL) % n

    def padz(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    tei, dL, dm1L, tc, Lf = (
        padz(ops.at.tei), padz(ops.at.disjL), padz(ops.at.disjm1L),
        padz(ops.totcoup), padz(ops.at.Lfac),
    )
    gidx = ops.at.gidx
    nrad = ops.at.Sinvh_rad.shape[0]
    per = (NL + pad) // n

    def k_shard(tei_l, dL_l, dm1L_l, tc_l, Lf_l, Pang):
        def body(K, xs):
            teiL, UL, VL, tcL, LfacL = xs
            R = LfacL * jnp.einsum("ok,kIJ->oIJ", tcL, Pang)
            return K + exchange_kernel_L(teiL, UL, VL, gidx, nrad, R), None

        nl = tc_l.shape[1]
        K = jnp.zeros((nl, nrad + 1, nrad + 1))
        K, _ = jax.lax.scan(body, K, (tei_l, dL_l, dm1L_l, tc_l, Lf_l))
        return -jax.lax.psum(K[:, :nrad, :nrad], "ch")

    k_sm = jax.shard_map(
        k_shard,
        mesh=mesh,
        in_specs=(P("ch"), P("ch"), P("ch"), P("ch"), P("ch"), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(lambda Pang: k_sm(tei, dL, dm1L, tc, Lf, Pang))
