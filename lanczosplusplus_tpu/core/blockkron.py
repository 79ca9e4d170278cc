"""Block-Kronecker Hamiltonians: direct sums of Kronecker blocks with
rectangular cross-block Kronecker couplings.

Several "non-factorizable" reference models are exactly factorizable
once the Hilbert space is viewed as a direct sum of product blocks:

- RashbaSOC (reference: src/Models/HubbardOneOrbitalRashbaSOC/
  BasisRashbaSOC.h:28-52): union over (nup, ndown) of product bases;
  spin-conserving terms are per-block Kronecker factors, the Rashba
  spin flips are (c-map (x) c-map) rectangular Kronecker couplings
  between adjacent blocks.
- t-J and FeAs spin-orbit sectors under a spatial half-cut: blocks are
  labelled by the left-half quantum numbers, within-half terms are
  block-diagonal dense half-Hamiltonians, cut-crossing bonds are
  rectangular (left (x) right) transfer couplings (same shape as
  models/heisenberg_factored.py, generalized).

Every hot op here is a dense GEMM instead of the generic gather-ELL
path those models otherwise run.

Block state layout: x splits into per-block (rows, cols) matrices
X_b[r, c] at static offsets; `matvec` applies

    Y_b = diag_b * X_b + row_op_b @ X_b + X_b @ col_op_b^T
        + sum_{cross: src=b'} sum_n L_n @ X_b' @ R_n^T  (+ h.c.)

where each cross coupling batches its bond index n into one pair of
batched GEMMs.  The flat ordering is whatever the caller's basis uses
(row-major rows x cols per block) so a BlockKronHamiltonian can swap
in for the flat ELL Hamiltonian transparently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from lanczosplusplus_tpu.config import matmul_precision



@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CrossTerm:
    """Y_dst += sum_n left[n] @ X_src @ right[n]^T, plus (when add_hc)
    the Hermitian partners Y_src += sum_n left[n]^H @ X_dst @
    conj(right[n])."""
    left: jax.Array    # (nb, rows_dst, rows_src)
    right: jax.Array   # (nb, cols_dst, cols_src)
    src: int = dataclasses.field(metadata=dict(static=True))
    dst: int = dataclasses.field(metadata=dict(static=True))
    add_hc: bool = dataclasses.field(metadata=dict(static=True),
                                     default=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PermCrossTerm:
    """Memory-light cross coupling for operators that are partial
    permutations on each factor (c / c^dag / S+- maps: <= 1 nonzero
    per row AND column):

      Y_dst[r, c] += sum_n row_amp[n, r] * col_amp[n, c]
                             * X_src[row_src[n, r], col_src[n, c]]

    i.e. one row gather + one column gather per bond instead of a
    dense (rows_dst, rows_src) factor — O(rows + cols) storage.
    Invalid destinations carry amp 0 (index 0)."""
    row_src: jax.Array   # (nb, rows_dst) int32 into src rows
    row_amp: jax.Array   # (nb, rows_dst)
    col_src: jax.Array   # (nb, cols_dst) int32 into src cols
    col_amp: jax.Array   # (nb, cols_dst)
    src: int = dataclasses.field(metadata=dict(static=True))
    dst: int = dataclasses.field(metadata=dict(static=True))
    # channel groups sharing an identical row_src map: the (rows_dst,
    # cols_src)-sized row gather — half the memory traffic of a
    # channel — is done once per group instead of once per channel
    # (builders compute this; None = one group per channel)
    groups: Optional[tuple] = dataclasses.field(
        metadata=dict(static=True), default=None)
    # "bf16": gather the source block in bfloat16 (half the gather
    # bytes of this bandwidth-bound path).  The amplitude tables stay
    # FULL precision, so host_matvec_f64 still applies the TRUE
    # operator and the RQI refinement recovers exact energies; the
    # quantized matvec also invalidates the selective-reorth omega
    # recurrence, so solvers force full reorthogonalization
    # (Hamiltonian.quantized)
    state_cast: Optional[str] = dataclasses.field(
        metadata=dict(static=True), default=None)
    # channel groups sharing an identical (col_src, col_amp) pair:
    # physically, the hopping and Rashba channels of one crossing bond
    # act with the SAME operator on one factor and differ only on the
    # other, so their row sides can be combined BEFORE the column
    # gather — one column gather per col group instead of per channel
    # (the column side is the larger half of the cross traffic).
    # None = one group per channel (legacy layout)
    col_groups: Optional[tuple] = dataclasses.field(
        metadata=dict(static=True), default=None)


def make_perm_cross(row_src, row_amp, col_src, col_amp, src, dst,
                    dtype, cross_dtype=None) -> "PermCrossTerm":
    """PermCrossTerm from host channel tables: computes the shared-
    row-map channel groups (one row gather per group in the apply),
    the shared-(col map, col amp) column groups (one column gather per
    col group), and applies the optional below-compute-precision state
    cast (bf16 halves the gather traffic; real inputs only)."""
    row_src = np.asarray(row_src)
    sig, groups = {}, []
    for k in range(row_src.shape[0]):
        key = row_src[k].tobytes()
        if key in sig:
            groups[sig[key]].append(k)
        else:
            sig[key] = len(groups)
            groups.append([k])
    col_src = np.asarray(col_src)
    col_amp_h = np.asarray(col_amp)
    csig, cgroups = {}, []
    for k in range(col_src.shape[0]):
        key = col_src[k].tobytes() + col_amp_h[k].tobytes()
        if key in csig:
            cgroups[csig[key]].append(k)
        else:
            csig[key] = len(cgroups)
            cgroups.append([k])
    state_cast = "bf16" if cross_dtype == jnp.bfloat16 else None
    return PermCrossTerm(
        row_src=jnp.asarray(row_src),
        row_amp=jnp.asarray(np.asarray(row_amp), dtype),
        col_src=jnp.asarray(col_src),
        col_amp=jnp.asarray(col_amp_h, dtype),
        src=src, dst=dst, groups=tuple(tuple(g) for g in groups),
        state_cast=state_cast,
        col_groups=tuple(tuple(g) for g in cgroups))


def _cross_groups(t: "PermCrossTerm"):
    return (t.groups if t.groups is not None
            else tuple((n,) for n in range(t.row_src.shape[0])))


def _cross_state(t: "PermCrossTerm", xsrc: jax.Array):
    """Source block for the gathers: with state_cast="bf16" (builder
    option cross_dtype=bf16) the block is cast down once so the
    gathers move half the bytes; the amplitude multiplies promote back
    to the state dtype.  Exact final energies come from the RQI
    refinement, whose host-f64 residual applies the unquantized
    amplitudes to the unquantized state."""
    if (getattr(t, "state_cast", None) == "bf16"
            and jnp.issubdtype(xsrc.dtype, jnp.floating)):
        return xsrc.astype(jnp.bfloat16)
    return xsrc


def _col_groups(t: "PermCrossTerm"):
    return (t.col_groups if t.col_groups is not None
            else tuple((n,) for n in range(t.col_src.shape[0])))


def _use_col_dedup(t: "PermCrossTerm") -> bool:
    cg = getattr(t, "col_groups", None)
    return cg is not None and any(len(g) > 1 for g in cg)


def _perm_cross_apply(t: "PermCrossTerm", xsrc: jax.Array) -> jax.Array:
    """(rows_dst, cols_dst) contribution of one PermCrossTerm.

    Applied bond-by-bond with 1-D-index row/column gathers on 2-D
    blocks, which XLA lowers to slice gathers (an N-D fancy gather or
    take_along_axis lowers to per-element gathers instead; how the two
    compare on the GPU is not measured).  Channels sharing a row map (groups)
    reuse one row gather; channels sharing a (col map, col amp) pair
    (col_groups — e.g. the hop and Rashba channels of one crossing
    bond) combine their row sides BEFORE the column gather, halving
    the column-side traffic; bf16 state cast (builder option) halves
    the gather bytes."""
    dtype = xsrc.dtype
    xg = _cross_state(t, xsrc)
    if not _use_col_dedup(t):
        acc = None
        for group in _cross_groups(t):
            rows = xg[t.row_src[group[0]]]     # (r_dst, c_src)
            for n in group:
                term = (t.row_amp[n][:, None] * rows[:, t.col_src[n]]
                        * t.col_amp[n][None, :]).astype(dtype)
                acc = term if acc is None else acc + term
        return acc
    group_of = {}
    rows_of = {}
    for gi, group in enumerate(_cross_groups(t)):
        rows_of[gi] = xg[t.row_src[group[0]]]  # (r_dst, c_src)
        for n in group:
            group_of[n] = gi
    acc = None
    for cgroup in _col_groups(t):
        pre = None
        for n in cgroup:
            term = t.row_amp[n][:, None] * rows_of[group_of[n]]
            pre = term if pre is None else pre + term
        pre = pre.astype(xg.dtype)             # keep bf16 gather bytes
        rep = cgroup[0]
        out = (pre[:, t.col_src[rep]]
               * t.col_amp[rep][None, :]).astype(dtype)
        acc = out if acc is None else acc + out
    return acc


def _perm_cross_apply_batched(t: "PermCrossTerm",
                              xsrc: jax.Array) -> jax.Array:
    """Batched (k, rows_dst, cols_dst) version of `_perm_cross_apply`
    for the SpMM recurrence; xsrc is (k, rows_src, cols_src)."""
    dtype = xsrc.dtype
    xg = _cross_state(t, xsrc)
    if not _use_col_dedup(t):
        acc = None
        for group in _cross_groups(t):
            rows = xg[:, t.row_src[group[0]]]  # (k, r_dst, c_src)
            for n in group:
                term = (t.row_amp[n][None, :, None]
                        * rows[:, :, t.col_src[n]]
                        * t.col_amp[n][None, None, :]).astype(dtype)
                acc = term if acc is None else acc + term
        return acc
    group_of = {}
    rows_of = {}
    for gi, group in enumerate(_cross_groups(t)):
        rows_of[gi] = xg[:, t.row_src[group[0]]]
        for n in group:
            group_of[n] = gi
    acc = None
    for cgroup in _col_groups(t):
        pre = None
        for n in cgroup:
            term = t.row_amp[n][None, :, None] * rows_of[group_of[n]]
            pre = term if pre is None else pre + term
        pre = pre.astype(xg.dtype)
        rep = cgroup[0]
        out = (pre[:, :, t.col_src[rep]]
               * t.col_amp[rep][None, None, :]).astype(dtype)
        acc = out if acc is None else acc + out
    return acc


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockKronHamiltonian:
    """Direct sum of Kronecker blocks with cross couplings.

    Optional TIERED application (see `tierize`): forms with many small
    blocks (the t-J half-cut has ~45) are dispatch-bound — one tiny
    GEMM kernel per block per op.  `tiers` groups same-padded-shape
    blocks; their diag/row/col applications run as ONE batched einsum
    per tier from the precomputed stacked tensors `diag_t`/`row_t`/
    `col_t`, while blocks not covered by a tier (the big ones, where a
    lone GEMM is already efficient) keep the per-block path."""
    diag: Tuple[jax.Array, ...]               # per block (rows, cols)
    row_ops: Tuple[Optional[jax.Array], ...]  # per block (rows, rows)
    col_ops: Tuple[Optional[jax.Array], ...]  # per block (cols, cols)
    cross: Tuple[CrossTerm, ...]
    shapes: tuple = dataclasses.field(metadata=dict(static=True))
    perm_cross: Tuple[PermCrossTerm, ...] = ()
    # tiered batching (optional): tiers = ((block_idxs, R, C), ...)
    tiers: Optional[tuple] = dataclasses.field(
        metadata=dict(static=True), default=None)
    diag_t: Tuple[jax.Array, ...] = ()        # per tier (k, R, C)
    row_t: Tuple[Optional[jax.Array], ...] = ()   # per tier (k, R, R)
    col_t: Tuple[Optional[jax.Array], ...] = ()   # per tier (k, C, C)

    @property
    def dim(self) -> int:
        return sum(r * c for (r, c) in self.shapes)

    @property
    def dtype(self):
        return self.diag[0].dtype

    @property
    def quantized(self) -> bool:
        """True when any matvec stage quantizes the state below the
        compute dtype (bf16 cross gathers): solvers then force full
        reorthogonalization — the selective omega recurrence assumes
        an exact three-term recurrence and silently collapses at the
        quantization noise level."""
        return any(getattr(t, "state_cast", None) is not None
                   for t in self.perm_cross)

    @property
    def nnz(self) -> int:
        """Number of couplings the equivalent flat ELL would hold
        (diag + per-block Kronecker rows + cross terms) — the basis
        for nnz/s accounting in benchmarks."""
        n = self.dim
        for b, (r, c) in enumerate(self.shapes):
            if self.row_ops[b] is not None:
                n += int(np.sum(np.asarray(self.row_ops[b]) != 0)) * c
            if self.col_ops[b] is not None:
                n += int(np.sum(np.asarray(self.col_ops[b]) != 0)) * r
        for t in self.cross:
            nl = int(np.sum(np.abs(np.asarray(t.left)) > 0, axis=(1, 2))
                     @ np.sum(np.abs(np.asarray(t.right)) > 0,
                              axis=(1, 2)))
            n += nl * (2 if t.add_hc else 1)
        for t in self.perm_cross:
            n += int(np.sum(np.asarray(t.row_amp) != 0, axis=1)
                     @ np.sum(np.asarray(t.col_amp) != 0, axis=1))
        return n

    def _split(self, x):
        out = []
        off = 0
        for (r, c) in self.shapes:
            out.append(x[off:off + r * c].reshape(r, c))
            off += r * c
        return out

    def _tier_members(self):
        out = set()
        for idxs, _, _ in (self.tiers or ()):
            out.update(idxs)
        return out

    def matvec(self, x):
        xs = self._split(x)
        in_tier = self._tier_members()
        ys = [self.diag[b] * xs[b] if b not in in_tier else None
              for b in range(len(xs))]
        pet = dict(preferred_element_type=x.dtype,
                   precision=matmul_precision())
        for t, (idxs, R, C) in enumerate(self.tiers or ()):
            xt = jnp.stack([jnp.pad(xs[b], ((0, R - self.shapes[b][0]),
                                            (0, C - self.shapes[b][1])))
                            for b in idxs])
            yt = self.diag_t[t] * xt
            if self.row_t[t] is not None:
                yt = yt + jnp.einsum("bsr,brc->bsc", self.row_t[t],
                                     xt, **pet)
            if self.col_t[t] is not None:
                yt = yt + jnp.einsum("brc,bdc->brd", xt,
                                     self.col_t[t], **pet)
            for pos, b in enumerate(idxs):
                r, c = self.shapes[b]
                ys[b] = yt[pos, :r, :c]
        for b in range(len(xs)):
            if b in in_tier:
                continue
            if self.row_ops[b] is not None:
                ys[b] = ys[b] + jax.lax.dot_general(
                    self.row_ops[b], xs[b],
                    dimension_numbers=(((1,), (0,)), ((), ())),
                    preferred_element_type=x.dtype,
                    precision=matmul_precision())
            if self.col_ops[b] is not None:
                ys[b] = ys[b] + jax.lax.dot_general(
                    xs[b], self.col_ops[b],
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=x.dtype,
                    precision=matmul_precision())
        for t in self.cross:
            # t1[n, r_src, c_dst] = X_src @ right[n]^T
            t1 = jnp.einsum("ndc,rc->nrd", t.right, xs[t.src], **pet)
            ys[t.dst] = ys[t.dst] + jnp.einsum(
                "nor,nrd->od", t.left, t1, **pet)
            if t.add_hc:
                t2 = jnp.einsum("rd,ndc->nrc", xs[t.dst],
                                jnp.conj(t.right), **pet)
                ys[t.src] = ys[t.src] + jnp.einsum(
                    "nor,noc->rc", jnp.conj(t.left), t2, **pet)
        for t in self.perm_cross:
            ys[t.dst] = ys[t.dst] + _perm_cross_apply(t, xs[t.src])
        return jnp.concatenate([y.reshape(-1) for y in ys])

    def matmat_t(self, xk):
        """Batch-major SpMM (k, dim) -> (k, dim): each block op folds
        the batch into the GEMM row/column dimension (pure GEMM)."""
        k = xk.shape[0]
        off = 0
        xs = []
        for (r, c) in self.shapes:
            xs.append(xk[:, off:off + r * c].reshape(k, r, c))
            off += r * c
        in_tier = self._tier_members()
        ys = [self.diag[b][None] * xs[b] if b not in in_tier else None
              for b in range(len(xs))]
        pet = dict(preferred_element_type=xk.dtype,
                   precision=matmul_precision())
        for t, (idxs, R, C) in enumerate(self.tiers or ()):
            xt = jnp.stack(
                [jnp.pad(xs[b], ((0, 0), (0, R - self.shapes[b][0]),
                                 (0, C - self.shapes[b][1])))
                 for b in idxs], axis=1)          # (k, nb, R, C)
            yt = self.diag_t[t][None] * xt
            if self.row_t[t] is not None:
                yt = yt + jnp.einsum("bsr,kbrc->kbsc", self.row_t[t],
                                     xt, **pet)
            if self.col_t[t] is not None:
                yt = yt + jnp.einsum("kbrc,bdc->kbrd", xt,
                                     self.col_t[t], **pet)
            for pos, b in enumerate(idxs):
                r, c = self.shapes[b]
                ys[b] = yt[:, pos, :r, :c]
        for b in range(len(xs)):
            if b in in_tier:
                continue
            r, c = self.shapes[b]
            if self.row_ops[b] is not None:
                t = jax.lax.dot_general(
                    xs[b], self.row_ops[b],
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=xk.dtype,
                    precision=matmul_precision())   # (k, c, r)
                ys[b] = ys[b] + jnp.swapaxes(t, 1, 2)
            if self.col_ops[b] is not None:
                ys[b] = ys[b] + jax.lax.dot_general(
                    xs[b].reshape(k * r, c), self.col_ops[b],
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=xk.dtype,
                    precision=matmul_precision()).reshape(k, r, c)
        for t in self.cross:
            t1 = jnp.einsum("ndc,krc->knrd", t.right, xs[t.src], **pet)
            ys[t.dst] = ys[t.dst] + jnp.einsum(
                "nor,knrd->kod", t.left, t1, **pet)
            if t.add_hc:
                t2 = jnp.einsum("krd,ndc->knrc", xs[t.dst],
                                jnp.conj(t.right), **pet)
                ys[t.src] = ys[t.src] + jnp.einsum(
                    "nor,knoc->krc", jnp.conj(t.left), t2, **pet)
        for t in self.perm_cross:
            ys[t.dst] = ys[t.dst] + _perm_cross_apply_batched(
                t, xs[t.src])
        return jnp.concatenate(
            [y.reshape(k, -1) for y in ys], axis=1)

    def to_dense(self) -> np.ndarray:
        dim = self.dim
        eye = np.eye(dim, dtype=np.asarray(self.diag[0]).dtype)
        cols = [np.asarray(self.matvec(jnp.asarray(eye[:, c])))
                for c in range(dim)]
        return np.stack(cols, axis=1)


def tierize(bk: BlockKronHamiltonian,
            max_elems: int = 1 << 18) -> BlockKronHamiltonian:
    """Group small blocks (rows*cols <= max_elems) into same-padded-
    shape tiers (dims rounded up to powers of two, so pad waste is
    bounded by 4x on FLOPs that are ~free at these sizes) and
    precompute the stacked diag/row/col tensors.  Blocks larger than
    the threshold keep the per-block GEMM path, where a lone GEMM
    is already efficient.  The per-block fields stay populated (nnz
    accounting, to_dense, host-f64 refinement use them)."""
    def up2(v):
        p = 8
        while p < v:
            p *= 2
        return p

    groups = {}
    for b, (r, c) in enumerate(bk.shapes):
        if r * c > max_elems or r < 2 or c < 2:
            continue
        groups.setdefault((up2(r), up2(c)), []).append(b)
    tiers, diag_t, row_t, col_t = [], [], [], []
    for (R, C), idxs in sorted(groups.items()):
        if len(idxs) < 2:
            continue
        tiers.append((tuple(idxs), R, C))
        diag_t.append(jnp.stack(
            [jnp.pad(bk.diag[b], ((0, R - bk.shapes[b][0]),
                                  (0, C - bk.shapes[b][1])))
             for b in idxs]))
        if any(bk.row_ops[b] is not None for b in idxs):
            row_t.append(jnp.stack(
                [jnp.pad(bk.row_ops[b] if bk.row_ops[b] is not None
                         else jnp.zeros((bk.shapes[b][0],) * 2,
                                        bk.diag[b].dtype),
                         ((0, R - bk.shapes[b][0]),) * 2)
                 for b in idxs]))
        else:
            row_t.append(None)
        if any(bk.col_ops[b] is not None for b in idxs):
            col_t.append(jnp.stack(
                [jnp.pad(bk.col_ops[b] if bk.col_ops[b] is not None
                         else jnp.zeros((bk.shapes[b][1],) * 2,
                                        bk.diag[b].dtype),
                         ((0, C - bk.shapes[b][1]),) * 2)
                 for b in idxs]))
        else:
            col_t.append(None)
    if not tiers:
        return bk
    return dataclasses.replace(
        bk, tiers=tuple(tiers), diag_t=tuple(diag_t),
        row_t=tuple(row_t), col_t=tuple(col_t))


def tierize_uniform(bk: BlockKronHamiltonian, pad_to: int = 128,
                    max_blowup: float = 8.0):
    """ONE tier holding every block, padded to a single (R, C): the
    whole within-block path (diag + row GEMMs + col GEMMs) runs as
    three batched einsum kernels instead of ~3 kernels per block.

    Many-small-block forms (the t-J half-cut: 25-45 blocks, largest a
    few hundred squared) are dispatch-bound, not FLOP-bound — measured
    2.9 ms for 8 GFLOP of GEMMs on the 18-site bench sector, an ~18x
    gap to the GEMM roofline that kernel batching closes.  The padding
    FLOPs are free at these sizes; `max_blowup` guards against
    applying this to forms with strongly heterogeneous block shapes
    (e.g. the Rashba half-cut), where padded-state memory and FLOPs
    would explode.  Returns `bk` unchanged when the guard trips."""
    def up(v):
        return max(8, -(-v // pad_to) * pad_to)

    R = up(max(r for r, _ in bk.shapes))
    C = up(max(c for _, c in bk.shapes))
    nb = len(bk.shapes)
    if nb < 2 or nb * R * C > max_blowup * bk.dim:
        return bk
    dt = bk.diag[0].dtype
    idxs = tuple(range(nb))
    diag_t = jnp.stack(
        [jnp.pad(bk.diag[b], ((0, R - bk.shapes[b][0]),
                              (0, C - bk.shapes[b][1])))
         for b in idxs])
    row_t = jnp.stack(
        [jnp.pad(bk.row_ops[b] if bk.row_ops[b] is not None
                 else jnp.zeros((bk.shapes[b][0],) * 2, dt),
                 ((0, R - bk.shapes[b][0]),) * 2)
         for b in idxs]) \
        if any(op is not None for op in bk.row_ops) else None
    col_t = jnp.stack(
        [jnp.pad(bk.col_ops[b] if bk.col_ops[b] is not None
                 else jnp.zeros((bk.shapes[b][1],) * 2, dt),
                 ((0, C - bk.shapes[b][1]),) * 2)
         for b in idxs]) \
        if any(op is not None for op in bk.col_ops) else None
    return dataclasses.replace(
        bk, tiers=((idxs, R, C),), diag_t=(diag_t,),
        row_t=(row_t,), col_t=(col_t,))


def tierize_classes(bk: BlockKronHamiltonian, max_blowup: float = 6.0):
    """Aspect-bucketed tiers: blocks are grouped {tall, square, wide}
    by aspect ratio and each bucket is padded to its max dims (128
    multiples above 128, powers of two below), so the whole GEMM path
    runs as ~3 batched einsum sets regardless of block count.  Falls
    back to the fine-grained `tierize` when the padded state would
    exceed `max_blowup` x dim (strongly heterogeneous shapes)."""
    def up(v):
        if v <= 8:
            return 8
        if v <= 128:
            p = 8
            while p < v:
                p *= 2
            return p
        return -(-v // 128) * 128

    buckets = {}
    for b, (r, c) in enumerate(bk.shapes):
        kind = "tall" if r > 2 * c else ("wide" if c > 2 * r
                                         else "square")
        buckets.setdefault(kind, []).append(b)
    tiers = []
    total = 0
    for kind, idxs in sorted(buckets.items()):
        if len(idxs) < 2:
            continue
        R = up(max(bk.shapes[b][0] for b in idxs))
        C = up(max(bk.shapes[b][1] for b in idxs))
        tiers.append((tuple(idxs), R, C))
        total += len(idxs) * R * C
    if not tiers or total + sum(
            bk.shapes[b][0] * bk.shapes[b][1]
            for b in range(len(bk.shapes))
            if not any(b in t[0] for t in tiers)) > max_blowup * bk.dim:
        return tierize(bk)
    dt = bk.diag[0].dtype

    def stack(ops, idxs, R, C, square_rows=None):
        if not any(ops[b] is not None for b in idxs):
            return None
        out = []
        for b in idxs:
            n = bk.shapes[b][0] if square_rows else bk.shapes[b][1]
            op = ops[b] if ops[b] is not None \
                else jnp.zeros((n, n), dt)
            pad = (R if square_rows else C) - n
            out.append(jnp.pad(op, ((0, pad),) * 2))
        return jnp.stack(out)

    diag_t, row_t, col_t = [], [], []
    for idxs, R, C in tiers:
        diag_t.append(jnp.stack(
            [jnp.pad(bk.diag[b], ((0, R - bk.shapes[b][0]),
                                  (0, C - bk.shapes[b][1])))
             for b in idxs]))
        row_t.append(stack(bk.row_ops, idxs, R, C, square_rows=True))
        col_t.append(stack(bk.col_ops, idxs, R, C, square_rows=False))
    return dataclasses.replace(
        bk, tiers=tuple(tiers), diag_t=tuple(diag_t),
        row_t=tuple(row_t), col_t=tuple(col_t))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PermutedHamiltonian:
    """Order adapter: applies an inner (block-ordered) Hamiltonian to
    vectors given in another basis order (two gathers around the inner
    matvec), so solvers and operator maps see the flat order.

    `sign` (optional, in inner/block order) carries a per-state +-1
    phase when the inner form uses a different Jordan-Wigner mode
    ordering than the flat basis (the half-cut Rashba factorization's
    (-1)^{au*bu} twist): flat state |f> = sign[inv[f]] * inner state,
    so H_flat = S P^T H_inner P S with S = diag(sign)."""
    inner: BlockKronHamiltonian
    perm: jax.Array   # block position p -> flat index perm[p]
    inv: jax.Array    # flat index f -> block position inv[f]
    sign: Optional[jax.Array] = None   # (dim,) inner order, +-1

    @property
    def dim(self):
        return self.inner.dim

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def nnz(self):
        return self.inner.nnz

    @property
    def quantized(self):
        return self.inner.quantized

    def matvec(self, x):
        xp = x[self.perm]
        if self.sign is not None:
            xp = xp * self.sign
        y = self.inner.matvec(xp)
        if self.sign is not None:
            y = y * self.sign
        return y[self.inv]

    def matmat_t(self, xk):
        xp = xk[:, self.perm]
        if self.sign is not None:
            xp = xp * self.sign[None, :]
        y = self.inner.matmat_t(xp)
        if self.sign is not None:
            y = y * self.sign[None, :]
        return y[:, self.inv]

    def to_dense(self):
        dim = self.dim
        eye = np.eye(dim, dtype=np.asarray(self.inner.diag[0]).dtype)
        cols = [np.asarray(self.matvec(jnp.asarray(eye[:, c])))
                for c in range(dim)]
        return np.stack(cols, axis=1)
