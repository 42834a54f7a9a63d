"""Finite-element basis layer (L2).

Device-batched redesign of FiniteElementBasis
(libhelfem/src/FiniteElementBasis.cpp, include/FiniteElementBasis.h):

* The reference drops boundary basis functions per boundary conditions by
  index surgery and loops over elements under OpenMP. Here every element keeps
  the full fixed [nprim] function slot layout; dropped functions have their
  basis-value columns ZEROED and their global index mapped to a trash slot
  (nbf). All per-element tensors have static shapes [nelem, nq, nprim] and the
  global assembly is one scatter-add -- XLA friendly and race-free by
  construction (replacing the per-element-buffer + serial reduction of
  FiniteElementBasis::matrix_element, FiniteElementBasis.cpp:327-349).

* Adjacent elements share `noverlap` functions (1 for nodal LIP/Legendre,
  nder+1 for Hermite bases, which share value AND derivative DOFs).

* Host-side table building in numpy f64 (from longdouble polynomial
  evaluation); device-side contraction helpers in jnp where needed per SCF
  iteration.
"""

from dataclasses import dataclass, field

import numpy as np

__all__ = ["FEMBasis"]


@dataclass
class FEMBasis:
    """Element partition + shape functions with boundary conditions.

    Global function g(e, i) = e*(nprim - noverlap) + i; boundary conditions
    remove the left/right edge value DOF (drop_first/drop_last) and
    optionally the edge derivative DOFs (drop_first_deriv/drop_last_deriv,
    Hermite bases only)."""

    poly: object
    bval: np.ndarray  # element boundaries [nelem+1]
    drop_first: bool = True
    drop_last: bool = True
    drop_first_deriv: bool = False
    drop_last_deriv: bool = False

    nelem: int = field(init=False)
    nprim: int = field(init=False)
    noverlap: int = field(init=False)
    nbf: int = field(init=False)
    gidx: np.ndarray = field(init=False)  # [nelem, nprim] -> global index or nbf (trash)
    mask: np.ndarray = field(init=False)  # [nelem, nprim] 1.0 kept / 0.0 dropped

    def __post_init__(self):
        self.bval = np.asarray(self.bval, dtype=np.float64)
        self.nelem = len(self.bval) - 1
        self.nprim = self.poly.nprim
        self.noverlap = getattr(self.poly, "noverlap", 1)
        v = self.noverlap
        nfull = self.nelem * (self.nprim - v) + v

        dropped_global = set()
        if self.drop_first:
            dropped_global.update(self.poly.left_dofs(deriv=False))
        if self.drop_first_deriv:
            dropped_global.update(self.poly.left_dofs(deriv=True))
        off = (self.nelem - 1) * (self.nprim - v)
        if self.drop_last:
            dropped_global.update(off + i for i in self.poly.right_dofs(deriv=False))
        if self.drop_last_deriv:
            dropped_global.update(off + i for i in self.poly.right_dofs(deriv=True))

        # renumber kept functions consecutively
        newidx = np.full(nfull, -1, dtype=np.int64)
        c = 0
        for gfull in range(nfull):
            if gfull not in dropped_global:
                newidx[gfull] = c
                c += 1
        self.nbf = c

        e = np.arange(self.nelem)[:, None]
        i = np.arange(self.nprim)[None, :]
        gfull = e * (self.nprim - v) + i
        g = newidx[gfull]
        self.gidx = np.where(g < 0, self.nbf, g).astype(np.int32)
        self.mask = np.where(g < 0, 0.0, 1.0)

    # --- geometry -----------------------------------------------------------
    @property
    def lengths(self) -> np.ndarray:
        return self.bval[1:] - self.bval[:-1]

    @property
    def mids(self) -> np.ndarray:
        return 0.5 * (self.bval[1:] + self.bval[:-1])

    def coords(self, x: np.ndarray) -> np.ndarray:
        """Real coordinates r[e, q] for primitive points x[q] in every element."""
        return self.mids[:, None] + 0.5 * self.lengths[:, None] * np.asarray(x)[None, :]

    # --- evaluation ---------------------------------------------------------
    def eval_element(self, e: int, x: np.ndarray, nder: int = 0) -> np.ndarray:
        """Basis values/derivatives of element e at primitive points x:
        [nder+1, nq, nprim], with d/dr chain-rule scaling and masked columns.
        (reference: PolynomialBasis::eval_dnf, PolynomialBasis.cpp:161-179)"""
        half = 0.5 * self.lengths[e]
        vals = self.poly.eval(x, nder, element_length=half)
        scale = (1.0 / half) ** np.arange(nder + 1)
        return vals * scale[:, None, None] * self.mask[e][None, None, :]

    def eval_element_div(self, e: int, x: np.ndarray, x0: float, nder: int = 0) -> np.ndarray:
        """Like eval_element but of f(x)/(x - x0) (for the b = B/r basis);
        dropped columns masked."""
        half = 0.5 * self.lengths[e]
        vals = self.poly.eval_div(x, x0, nder, element_length=half)
        scale = (1.0 / half) ** np.arange(nder + 1)
        return vals * scale[:, None, None] * self.mask[e][None, None, :]

    def eval_dnf(self, x: np.ndarray, nder: int = 0) -> np.ndarray:
        """Element-stacked basis values/derivatives [nder+1, nelem, nq, nprim]."""
        return np.stack(
            [self.eval_element(e, x, nder) for e in range(self.nelem)], axis=1
        )

    # --- assembly -----------------------------------------------------------
    def assemble(self, elmat: np.ndarray) -> np.ndarray:
        """Scatter-add per-element matrices [..., nelem, nprim, nprim] into the
        global [..., nbf, nbf] matrix."""
        lead = elmat.shape[:-3]
        out = np.zeros(lead + (self.nbf + 1, self.nbf + 1), dtype=elmat.dtype)
        for e in range(self.nelem):
            ix = self.gidx[e]
            out[..., ix[:, None], ix[None, :]] += elmat[..., e, :, :]
        return out[..., : self.nbf, : self.nbf]

    def assemble_vec(self, elvec: np.ndarray) -> np.ndarray:
        """Scatter-add per-element vectors [..., nelem, nprim] -> [..., nbf]."""
        lead = elvec.shape[:-2]
        out = np.zeros(lead + (self.nbf + 1,), dtype=elvec.dtype)
        for e in range(self.nelem):
            out[..., self.gidx[e]] += elvec[..., e, :]
        return out[..., : self.nbf]

    def gather(self, mat: np.ndarray) -> np.ndarray:
        """Gather a global [..., nbf, nbf] matrix to element windows
        [..., nelem, nprim, nprim] (inverse of assemble; shared boundary
        entries are replicated into both adjacent elements)."""
        pad = np.zeros(mat.shape[:-2] + (self.nbf + 1, self.nbf + 1), dtype=mat.dtype)
        pad[..., : self.nbf, : self.nbf] = mat
        return pad[..., self.gidx[:, :, None], self.gidx[:, None, :]]

    def matrix_element(
        self,
        lhder: int,
        rhder: int,
        xq: np.ndarray,
        wq: np.ndarray,
        f: np.ndarray | None = None,
        lh_bf: np.ndarray | None = None,
        rh_bf: np.ndarray | None = None,
    ) -> np.ndarray:
        """Global matrix of <d^a u | f(r) | d^b v>.

        f is either None (=1) or values on the element grid [nelem, nq].
        lh_bf/rh_bf override the basis-value tensors [nelem, nq, nprim] (used
        by the radial layer to pass b=B/r functions).
        (reference: FiniteElementBasis::matrix_element,
        FiniteElementBasis.cpp:327-415)
        """
        if lh_bf is None or rh_bf is None:
            nder = max(lhder, rhder)
            dn = self.eval_dnf(xq, nder)
            if lh_bf is None:
                lh_bf = dn[lhder]
            if rh_bf is None:
                rh_bf = dn[rhder]
        w = wq[None, :] * (0.5 * self.lengths)[:, None]
        if f is not None:
            w = w * f
        elmat = np.einsum("eqi,eq,eqj->eij", lh_bf, w, rh_bf, optimize=True)
        return self.assemble(elmat)
