"""Block-factorized Kitaev solver: the full 2^n space as a Kronecker
product of two half-chains, so every hot op is a dense matmul.

The Kitaev model conserves nothing (reference: BasisKitaev.h:28-34 uses
the identity basis over 2^n words), so the state vector reshapes
losslessly into a (2^nL, 2^nR) matrix over a left/right site cut
(left = high bits, right = low bits).  The Hamiltonian splits exactly:

    H = D + H_L (x) I + I (x) H_R + sum_k P_k (x) Q_k

- D: ALL SzSz couplings and the magnetic field are diagonal in the
  product basis — one elementwise multiply of the reshaped state.
- H_L / H_R: within-half S+S- and S+S+/S-S- exchange, assembled as
  dense (2^nL, 2^nL) / (2^nR, 2^nR) matrices: one GEMM each.
- P_k (x) Q_k: each cut-crossing bond contributes up to four Kronecker
  terms (S+S-, S-S+, S+S+, S-S-) of single-site raising/lowering
  matrices: a batched GEMM pair per matvec.

No fermion signs (spins commute), no sector bookkeeping — this is the
simplest possible instance of the half-cut factorization used for the
Sz-blocked Heisenberg solver (models/heisenberg_factored.py) and it
replaces the gather-ELL SpMV (memory-bound) with pure GEMM work.
Selected by SolverOptions=factored (same flag as Heisenberg).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from lanczosplusplus_tpu.core import bits
from lanczosplusplus_tpu.core.sparse import _downcast_state
from lanczosplusplus_tpu.core.bits import WORD
from lanczosplusplus_tpu.config import matmul_precision


def _half_offdiag(m: int, pairs_pm, pairs_pp, jpm, jpp,
                  site_of, dtype):
    """Dense off-diagonal exchange matrix over the 2^m words of one
    half.  pairs_pm are ordered (i, j) global site pairs (S+_i S-_j
    with coefficient jpm[i, j]); pairs_pp unordered (S+S+ + S-S-,
    coefficient jpp[i, j])."""
    dim = 1 << m
    words = np.arange(dim, dtype=WORD)
    h = np.zeros((dim, dim), dtype=dtype)
    for (i, j) in pairs_pm:
        bi, bj = site_of(i), site_of(j)
        ok = (bits.get_bit(words, bi) == 0) & (bits.get_bit(words, bj) == 1)
        flip = WORD((1 << bi) | (1 << bj))
        tgt = (words ^ flip).astype(np.int64)
        np.add.at(h, (tgt[ok], words[ok].astype(np.int64)), jpm[i, j])
    for (i, j) in pairs_pp:
        bi, bj = site_of(i), site_of(j)
        occ_i = bits.get_bit(words, bi)
        occ_j = bits.get_bit(words, bj)
        ok = (occ_i == occ_j)
        flip = WORD((1 << bi) | (1 << bj))
        tgt = (words ^ flip).astype(np.int64)
        np.add.at(h, (tgt[ok], words[ok].astype(np.int64)), jpp[i, j])
    return h


def _site_op(m: int, b: int, raise_: bool, dtype):
    """Dense S+ (raise_=True) or S- single-site matrix on a 2^m half."""
    dim = 1 << m
    words = np.arange(dim, dtype=WORD)
    h = np.zeros((dim, dim), dtype=dtype)
    occ = bits.get_bit(words, b)
    ok = (occ == 0) if raise_ else (occ == 1)
    tgt = (words ^ WORD(1 << b)).astype(np.int64)
    h[tgt[ok], words[ok].astype(np.int64)] = 1.0
    return h


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FactoredKitaevHamiltonian:
    diag2d: jax.Array     # (dimL, dimR) all diagonal terms
    hl: jax.Array         # (dimL, dimL) within-left exchange
    hr_t: jax.Array       # (dimR, dimR) transposed within-right exchange
    p: jax.Array          # (K, dimL, dimL) cut-crossing left factors
    q: jax.Array          # (K, dimR, dimR) cut-crossing right factors

    @property
    def dim(self):
        return self.diag2d.shape[0] * self.diag2d.shape[1]

    @property
    def dtype(self):
        return self.diag2d.dtype

    def matvec(self, x):
        dl, dr = self.diag2d.shape
        xm = x.reshape(dl, dr)
        y = self.diag2d * xm
        # factors may be stored in bfloat16 (FLOP-bound workload:
        # native-bf16 GEMMs with f32 accumulation) — cast the state tile
        # down, accumulate in the compute dtype
        xc = _downcast_state(xm, self.hl.dtype)
        y = y + jax.lax.dot_general(
            self.hl, xc, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=x.dtype,
            precision=matmul_precision())
        y = y + jax.lax.dot_general(
            xc, self.hr_t, dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=x.dtype,
            precision=matmul_precision())
        if self.p.shape[0]:
            # sum_k P_k X Q_k^T
            px = jnp.einsum("kab,bd->kad", self.p, xc,
                            preferred_element_type=x.dtype,
                            precision=matmul_precision())
            y = y + jnp.einsum("kad,kcd->ac",
                               _downcast_state(px, self.q.dtype), self.q,
                               preferred_element_type=x.dtype,
                               precision=matmul_precision())
        return y.reshape(-1)

    def matmat(self, x):
        dl, dr = self.diag2d.shape
        nb = x.shape[1]
        xm = x.reshape(dl, dr, nb)
        y = self.diag2d[:, :, None] * xm
        xc = _downcast_state(xm, self.hl.dtype)
        y = y + jnp.einsum("ab,brB->arB", self.hl, xc,
                           preferred_element_type=x.dtype,
                           precision=matmul_precision())
        y = y + jnp.einsum("adB,cd->acB", xc, self.hr_t.T,
                           preferred_element_type=x.dtype,
                           precision=matmul_precision())
        if self.p.shape[0]:
            px = jnp.einsum("kab,bdB->kadB", self.p, xc,
                            preferred_element_type=x.dtype,
                            precision=matmul_precision())
            y = y + jnp.einsum("kadB,kcd->acB",
                               _downcast_state(px, self.q.dtype), self.q,
                               preferred_element_type=x.dtype,
                               precision=matmul_precision())
        return y.reshape(-1, nb)

    def matmat_t(self, xk):
        """Batch-major (k, dim) apply — see Hamiltonian.matmat_t."""
        dl, dr = self.diag2d.shape
        k = xk.shape[0]
        xm = xk.reshape(k, dl, dr)
        y = self.diag2d[None] * xm
        xc = _downcast_state(xm, self.hl.dtype)
        y = y + jax.lax.dot_general(          # right half: pure GEMM
            xc.reshape(k * dl, dr), self.hr_t,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=xk.dtype,
            precision=matmul_precision()).reshape(k, dl, dr)
        t = jax.lax.dot_general(              # left half: one swap
            xc, self.hl,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=xk.dtype,
            precision=matmul_precision())  # (k, dr, dl)
        y = y + jnp.swapaxes(t, 1, 2)
        if self.p.shape[0]:
            px = jnp.einsum("kab,Bbd->kBad", self.p, xc,
                            preferred_element_type=xk.dtype,
                            precision=matmul_precision())
            y = y + jnp.einsum("kBad,kcd->Bac",
                               _downcast_state(px, self.q.dtype), self.q,
                               preferred_element_type=xk.dtype,
                               precision=matmul_precision())
        return y.reshape(k, -1)

    def to_dense(self):
        eye = np.eye(self.dim, dtype=np.float64)
        cols = [np.asarray(self.matvec(jnp.asarray(
            eye[:, c], dtype=self.diag2d.dtype)))
            for c in range(self.dim)]
        return np.stack(cols, axis=1)


def build_factored_kitaev(model, basis, dtype=np.float64,
                          n_left=None,
                          factor_dtype=None) -> FactoredKitaevHamiltonian:
    """Split the KitaevModel Hamiltonian over a site cut.

    Right half = sites [0, nR) (low word bits), left = [nR, n).  The
    flat basis order (words ascending) IS the row-major order of the
    (2^nL, 2^nR) reshape, so no permutation wrapper is needed.

    factor_dtype (e.g. jnp.bfloat16) stores the half/cross factor
    matrices below the compute precision (native-bf16 GEMMs with
    f32 accumulation, ~4e-3 coupling quantization); its gain on the
    GPU is not measured."""
    n = basis.nsite
    n_l = n_left if n_left is not None else n // 2
    n_r = n - n_l
    in_left = lambda s: s >= n_r

    jpm, jpp = model.jpm, model.jpp
    pm_pairs = [(i, j) for i in range(n) for j in range(n)
                if i != j and jpm[i, j] != 0]
    pp_pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
                if jpp[i, j] != 0]

    hl = _half_offdiag(
        n_l,
        [(i, j) for (i, j) in pm_pairs if in_left(i) and in_left(j)],
        [(i, j) for (i, j) in pp_pairs if in_left(i) and in_left(j)],
        jpm, jpp, lambda s: s - n_r, dtype)
    hr = _half_offdiag(
        n_r,
        [(i, j) for (i, j) in pm_pairs if not in_left(i) and not in_left(j)],
        [(i, j) for (i, j) in pp_pairs if not in_left(i) and not in_left(j)],
        jpm, jpp, lambda s: s, dtype)

    p_list, q_list = [], []

    def add_cross(lsite, rsite, coeff, l_raise, r_raise):
        if coeff == 0:
            return
        p_list.append(coeff * _site_op(n_l, lsite - n_r, l_raise, dtype))
        q_list.append(_site_op(n_r, rsite, r_raise, dtype))

    for (i, j) in pm_pairs:        # S+_i S-_j, coefficient jpm[i, j]
        if in_left(i) != in_left(j):
            if in_left(i):         # S+ on left, S- on right
                add_cross(i, j, jpm[i, j], True, False)
            else:                  # S+ on right, S- on left
                add_cross(j, i, jpm[i, j], False, True)
    for (i, j) in pp_pairs:        # jpp (S+S+ + S-S-), unordered
        if in_left(i) != in_left(j):
            l, r = (i, j) if in_left(i) else (j, i)
            add_cross(l, r, jpp[i, j], True, True)
            add_cross(l, r, jpp[i, j], False, False)

    dl, dr = 1 << n_l, 1 << n_r
    p = np.stack(p_list) if p_list else np.zeros((0, dl, dl), dtype)
    q = np.stack(q_list) if q_list else np.zeros((0, dr, dr), dtype)
    diag = model.diagonal(basis).astype(dtype).reshape(dl, dr)
    fdt = factor_dtype or dtype
    return FactoredKitaevHamiltonian(
        diag2d=jnp.asarray(diag), hl=jnp.asarray(hl, dtype=fdt),
        hr_t=jnp.asarray(hr.T.copy(), dtype=fdt),
        p=jnp.asarray(p, dtype=fdt), q=jnp.asarray(q, dtype=fdt))
