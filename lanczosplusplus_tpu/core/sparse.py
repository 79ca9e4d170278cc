"""Sparse Hamiltonian containers and device kernels.

The reference stores each sector Hamiltonian as a CRS matrix assembled
row-by-row with a duplicate-merging SparseRow accumulator (reference:
src/Engine/DefaultSymmetry.h:54-57, PsimagLite CrsMatrix/SparseRow used
at src/Models/HubbardOneOrbital/HubbardHelper.h:75-103).

ED Hamiltonians have *bounded* row sparsity (<= a few entries per
Hamiltonian term), so the device layout is ELL: per-row padded
(cols, vals) arrays applied as gathers — static shapes, fully
vectorized, shardable by rows.

Two structural refinements exploited here:

- ``SpinFactorizedPart``: terms acting on only one spin species (e.g.
  Hubbard hopping) are Kronecker products I (x) A_up or A_dn (x) I.
  Applying them on the state reshaped to (size_down, size_up) is an
  axis-wise batched gather: index memory is O(size_up * K) instead of
  O(dim * K) and the gather has long contiguous second axes.
- the diagonal is kept separate (every row has one).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from lanczosplusplus_tpu.config import matmul_precision


def coo_to_ell(dim: int, rows: np.ndarray, cols: np.ndarray,
               vals: np.ndarray, min_k: int = 1):
    """Merge-duplicate COO -> padded ELL (cols, vals) numpy arrays.

    Padding entries point at their own row with value 0 so the gather
    stays in-bounds.  Equivalent to SparseRow::finalize's duplicate
    merging (reference: PsimagLite SparseRow, used at
    HubbardHelper.h:99).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    if rows.size == 0:
        k = max(min_k, 1)
        return (np.tile(np.arange(dim, dtype=np.int32)[:, None], (1, k)),
                np.zeros((dim, k), dtype=vals.dtype if vals.size else np.float64))
    key = rows * np.int64(dim) + cols
    order = np.argsort(key, kind="stable")
    key_s, vals_s = key[order], vals[order]
    uniq, inv = np.unique(key_s, return_inverse=True)
    merged = np.zeros(uniq.shape[0], dtype=vals.dtype)
    np.add.at(merged, inv, vals_s)
    nz = merged != 0
    uniq, merged = uniq[nz], merged[nz]
    r = (uniq // dim).astype(np.int64)
    c = (uniq % dim).astype(np.int64)
    counts = np.bincount(r, minlength=dim)
    k = max(int(counts.max(initial=0)), min_k)
    # position of each entry within its row
    offsets = np.zeros(dim + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    pos = np.arange(r.shape[0], dtype=np.int64) - offsets[r]
    ell_cols = np.tile(np.arange(dim, dtype=np.int64)[:, None], (1, k))
    ell_vals = np.zeros((dim, k), dtype=vals.dtype)
    ell_cols[r, pos] = c
    ell_vals[r, pos] = merged
    return ell_cols.astype(np.int32), ell_vals


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllPart:
    """Generic ELL block: y[i] += sum_k vals[i,k] * x[cols[i,k]]."""
    cols: jax.Array  # (dim, K) int32
    vals: jax.Array  # (dim, K)

    def apply(self, x):
        return jnp.sum(self.vals * x[self.cols], axis=-1)

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0] * self.cols.shape[1])



def _downcast_state(x, factor_dtype):
    """Cast a state tile down ONLY for the explicit bfloat16
    throughput mode on real states.  Complex states and ordinary
    precision mismatches must NOT be cast (an astype would silently
    drop the imaginary part / mantissa); dot_general's type promotion
    handles those correctly."""
    if (factor_dtype == jnp.bfloat16 and
            jnp.issubdtype(x.dtype, jnp.floating)):
        return x.astype(jnp.bfloat16)
    return x

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpinFactorizedPart:
    """Kronecker-structured one-spin hop maps.

    x is viewed as X[size_down, size_up]; `up` acts along axis 1
    (I_down (x) A_up), `dn` along axis 0 (A_dn (x) I_up).

    Two execution strategies:
    - gather form (`*_cols`/`*_vals` ELL maps): bandwidth-bound, used
      when the dense factors would not fit;
    - dense form (`up_dense`/`dn_dense`): the one-spin operators are
      materialized as (size, size) matrices and applied as GEMMs —
      Y += X @ up_dense^T; Y += dn_dense @ X — which turns the whole
      Lanczos hot loop into GEMMs.  For a half-filled n-site Hubbard
      chain the factor is C(n, n/2)^2 entries (47 MB at n=14).  Which
      form is faster depends on the sector size and the matmul
      precision (PERF.md); the gather form is the default.
    """
    up_cols: Optional[jax.Array]  # (size_up, Ku) int32
    up_vals: Optional[jax.Array]
    dn_cols: Optional[jax.Array]  # (size_down, Kd) int32
    dn_vals: Optional[jax.Array]
    up_dense: Optional[jax.Array] = None  # (size_up, size_up)
    dn_dense: Optional[jax.Array] = None  # (size_down, size_down)

    def apply(self, x2d):
        y = jnp.zeros_like(x2d)
        if self.up_dense is not None:
            # dense factors may be stored below the compute precision
            # (bfloat16): cast the state tile down, accumulate in the
            # compute dtype — native bf16 GEMMs with f32
            # accumulation
            xu = _downcast_state(x2d, self.up_dense.dtype)
            # y[d, u] += sum_c A_u[u, c] x[d, c]
            y = y + jax.lax.dot_general(
                xu, self.up_dense,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=x2d.dtype,
                precision=matmul_precision())
        elif self.up_cols is not None:
            # transpose once and turn the column gathers into
            # contiguous row gathers, then transpose back
            xt = x2d.T  # (szu, szd)
            acc = jnp.zeros_like(xt)
            for k in range(self.up_cols.shape[1]):
                acc = acc + self.up_vals[:, k, None] * \
                    xt[self.up_cols[:, k], :]
            y = y + acc.T
        if self.dn_dense is not None:
            xd = _downcast_state(x2d, self.dn_dense.dtype)
            y = y + jax.lax.dot_general(
                self.dn_dense, xd,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=x2d.dtype,
                precision=matmul_precision())
        elif self.dn_cols is not None:
            for k in range(self.dn_cols.shape[1]):
                y = y + self.dn_vals[:, k, None] * x2d[self.dn_cols[:, k], :]
        return y

    @property
    def nnz(self) -> int:
        n = 0
        if self.up_cols is not None:
            n += int(np.prod(self.up_cols.shape))
        if self.dn_cols is not None:
            n += int(np.prod(self.dn_cols.shape))
        return n


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Hamiltonian:
    """Sector Hamiltonian H = diag + ELL + spin-factorized parts.

    This is what the Lanczos solver applies; it replaces both
    InternalProductStored (stored CRS) and the threaded matrix-free
    apply (reference: src/Engine/InternalProductStored.h:104-132,
    HubbardHelper.h:105-134) with one static-shape functional object.
    """
    diag: jax.Array                      # (dim,)
    ell: Optional[EllPart]
    factorized: Optional[SpinFactorizedPart]
    spin_shape: Optional[Tuple[int, int]] = dataclasses.field(
        metadata=dict(static=True), default=None)  # (size_down, size_up)

    @property
    def dim(self) -> int:
        return self.diag.shape[0]

    @property
    def dtype(self):
        if self.ell is not None:
            return self.ell.vals.dtype
        if self.factorized is not None:
            for v in (self.factorized.up_vals, self.factorized.dn_vals):
                if v is not None:
                    return v.dtype
        return self.diag.dtype

    def matvec(self, x):
        y = self.diag * x
        if self.factorized is not None:
            x2d = x.reshape(self.spin_shape)
            y = y + self.factorized.apply(x2d).reshape(-1)
        if self.ell is not None:
            y = y + self.ell.apply(x)
        return y

    def matmat(self, x):
        """Batched SpMM: apply H to the columns of x (dim, k) — block
        Lanczos / batched spectral runs amortize index traffic over the
        block (the north-star's batched SpMM)."""
        y = self.diag[:, None] * x
        if self.factorized is not None:
            f = self.factorized
            szd, szu = self.spin_shape
            k = x.shape[1]
            # (szd, szu, k) batched view; dense factors stay GEMMs
            x3 = x.reshape(szd, szu, k)
            if f.up_dense is not None:
                xu = _downcast_state(x3, f.up_dense.dtype)
                y3 = jax.lax.dot_general(
                    f.up_dense, xu,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=x.dtype,
                    precision=matmul_precision())  # (szu, szd, k)
                y = y + jnp.transpose(y3, (1, 0, 2)).reshape(-1, k)
            elif f.up_cols is not None:
                acc = jnp.zeros_like(x3)
                for kk in range(f.up_cols.shape[1]):
                    acc = acc + f.up_vals[None, :, kk, None] * \
                        x3[:, f.up_cols[:, kk], :]
                y = y + acc.reshape(-1, k)
            if f.dn_dense is not None:
                xd = _downcast_state(x3, f.dn_dense.dtype)
                y3 = jax.lax.dot_general(
                    f.dn_dense, xd,
                    dimension_numbers=(((1,), (0,)), ((), ())),
                    preferred_element_type=x.dtype,
                    precision=matmul_precision())  # (szd, szu, k)
                y = y + y3.reshape(-1, k)
            elif f.dn_cols is not None:
                acc = jnp.zeros_like(x3)
                for kk in range(f.dn_cols.shape[1]):
                    acc = acc + f.dn_vals[:, kk, None, None] * \
                        x3[f.dn_cols[:, kk], :, :]
                y = y + acc.reshape(-1, k)
        if self.ell is not None:
            y = y + jnp.einsum("rk,rkb->rb", self.ell.vals,
                               x[self.ell.cols, :],
                               precision=matmul_precision())
        return y

    def matmat_t(self, xk):
        """Batch-MAJOR SpMM: apply H to the rows of xk (k, dim).

        The (dim, k) column layout of `matmat` forces strided
        transposes around the factor GEMMs (k is the minor dim).  With
        the batch leading, the up-factor contraction folds (k, szd)
        into the GEMM row dimension (pure GEMM, no transpose) and the
        dn-factor needs a single well-tiled (k, u, c)->(k, c, u)
        transpose per application.  Recurrences (FTLM/KPM) keep their
        carriers in this layout for the whole scan."""
        y = self.diag[None, :] * xk
        k = xk.shape[0]
        if self.factorized is not None:
            f = self.factorized
            szd, szu = self.spin_shape
            x3 = xk.reshape(k, szd, szu)
            if f.up_dense is not None:
                xu = _downcast_state(x3, f.up_dense.dtype)
                t = jax.lax.dot_general(
                    xu.reshape(k * szd, szu), f.up_dense,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=xk.dtype,
                    precision=matmul_precision())       # (k*d, v)
                y = y + t.reshape(k, -1)
            elif f.up_cols is not None:
                acc = jnp.zeros_like(x3)
                for kk in range(f.up_cols.shape[1]):
                    acc = acc + f.up_vals[None, None, :, kk] * \
                        x3[:, :, f.up_cols[:, kk]]
                y = y + acc.reshape(k, -1)
            if f.dn_dense is not None:
                xd = _downcast_state(x3, f.dn_dense.dtype)
                t = jax.lax.dot_general(
                    xd, f.dn_dense,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=xk.dtype,
                    precision=matmul_precision())       # (k, u, c)
                y = y + jnp.swapaxes(t, 1, 2).reshape(k, -1)
            elif f.dn_cols is not None:
                acc = jnp.zeros_like(x3)
                for kk in range(f.dn_cols.shape[1]):
                    acc = acc + f.dn_vals[None, :, kk, None] * \
                        x3[:, f.dn_cols[:, kk], :]
                y = y + acc.reshape(k, -1)
        if self.ell is not None:
            y = y + jnp.einsum("rs,brs->br", self.ell.vals,
                               xk[:, self.ell.cols],
                               precision=matmul_precision())
        return y

    @property
    def nnz(self) -> int:
        n = self.dim  # diagonal
        if self.ell is not None:
            n += self.ell.nnz
        if self.factorized is not None:
            f = self.factorized
            if f.up_cols is not None:
                n += self.spin_shape[0] * int(np.prod(f.up_cols.shape))
            if f.dn_cols is not None:
                n += self.spin_shape[1] * int(np.prod(f.dn_cols.shape))
        return n

    def densify_factors(self, max_bytes: int = 2 << 30,
                        factor_dtype=None) -> "Hamiltonian":
        """Materialize the Kronecker one-spin factors as dense matrices
        when they fit in `max_bytes`, so matvec runs as GEMMs.

        factor_dtype (e.g. jnp.bfloat16) stores the factors below the
        compute precision: the GEMMs then run native-bf16 with f32
        accumulation at ~4e-3 relative hop-amplitude quantization — a
        throughput mode for when the factor GEMMs, not HBM, dominate."""
        f = self.factorized
        if f is None:
            return self
        szd, szu = self.spin_shape

        def densify(cols, vals, size):
            if cols is None:
                return None
            itemsize = np.dtype(vals.dtype).itemsize
            if size * size * itemsize > max_bytes:
                return None
            c = np.asarray(cols)
            v = np.asarray(vals)
            a = np.zeros((size, size), dtype=v.dtype)
            r = np.repeat(np.arange(size), c.shape[1])
            np.add.at(a, (r, c.reshape(-1)), v.reshape(-1))
            return jnp.asarray(a, factor_dtype or v.dtype)

        up_d = densify(f.up_cols, f.up_vals, szu)
        dn_d = densify(f.dn_cols, f.dn_vals, szd)
        if up_d is None and dn_d is None:
            return self
        # the ELL maps are kept alongside (they are tiny) so
        # flatten_to_ell/to_dense keep working on the gather form
        return Hamiltonian(
            diag=self.diag, ell=self.ell,
            factorized=SpinFactorizedPart(
                up_cols=f.up_cols, up_vals=f.up_vals,
                dn_cols=f.dn_cols, dn_vals=f.dn_vals,
                up_dense=up_d, dn_dense=dn_d),
            spin_shape=self.spin_shape)

    def flatten_to_ell(self) -> "Hamiltonian":
        """Merge factorized Kronecker parts into one generic ELL block.

        The row-partitioned distributed path and the Pallas SpMV kernel
        consume a single (cols, vals) layout; the Kronecker indices
        expand by broadcasting, no COO round-trip."""
        if self.factorized is None:
            return self
        szd, szu = self.spin_shape
        blocks_c, blocks_v = [], []
        f = self.factorized
        if f.up_cols is not None:
            ku = f.up_cols.shape[1]
            base = (jnp.arange(szd, dtype=jnp.int32) * szu)[:, None, None]
            c = (f.up_cols[None, :, :] + base).reshape(szd * szu, ku)
            v = jnp.broadcast_to(f.up_vals[None, :, :],
                                 (szd, szu, ku)).reshape(szd * szu, ku)
            blocks_c.append(c)
            blocks_v.append(v)
        if f.dn_cols is not None:
            kd = f.dn_cols.shape[1]
            iu = jnp.arange(szu, dtype=jnp.int32)[None, :, None]
            c = (f.dn_cols[:, None, :] * szu + iu).reshape(szd * szu, kd)
            v = jnp.broadcast_to(f.dn_vals[:, None, :],
                                 (szd, szu, kd)).reshape(szd * szu, kd)
            blocks_c.append(c)
            blocks_v.append(v)
        if self.ell is not None:
            blocks_c.append(self.ell.cols)
            blocks_v.append(self.ell.vals)
        ell = EllPart(cols=jnp.concatenate(blocks_c, axis=1).astype(jnp.int32),
                      vals=jnp.concatenate(blocks_v, axis=1))
        return Hamiltonian(diag=self.diag, ell=ell, factorized=None,
                           spin_shape=None)

    def padded(self, multiple: int) -> "Hamiltonian":
        """Pad rows to a multiple (for even sharding); padding rows are
        zero with self-referencing columns.  Flattens to ELL form."""
        h = self.flatten_to_ell()
        dim = h.dim
        rem = (-dim) % multiple
        if rem == 0:
            return h
        newdim = dim + rem
        k = h.ell.cols.shape[1]
        pad_cols = jnp.tile(
            jnp.arange(dim, newdim, dtype=jnp.int32)[:, None], (1, k))
        cols = jnp.concatenate([h.ell.cols, pad_cols], axis=0)
        vals = jnp.concatenate(
            [h.ell.vals, jnp.zeros((rem, k), h.ell.vals.dtype)], axis=0)
        diag = jnp.concatenate(
            [h.diag, jnp.zeros((rem,), h.diag.dtype)])
        return Hamiltonian(diag=diag, ell=EllPart(cols=cols, vals=vals),
                           factorized=None, spin_shape=None)

    def to_dense(self) -> np.ndarray:
        """Dense matrix for oracle tests (reference dumpmatrix path,
        src/Engine/DefaultSymmetry.h:61-94)."""
        dim = self.dim
        m = np.zeros((dim, dim), dtype=np.asarray(self.diag).dtype
                     if self.ell is None else np.asarray(self.ell.vals).dtype)
        m[np.arange(dim), np.arange(dim)] += np.asarray(self.diag)
        if self.ell is not None:
            cols = np.asarray(self.ell.cols)
            vals = np.asarray(self.ell.vals)
            r = np.repeat(np.arange(dim), cols.shape[1])
            np.add.at(m, (r, cols.reshape(-1)), vals.reshape(-1))
        if self.factorized is not None:
            szd, szu = self.spin_shape
            f = self.factorized
            if f.up_cols is not None:
                cu = np.asarray(f.up_cols)
                vu = np.asarray(f.up_vals)
                a = np.zeros((szu, szu), dtype=m.dtype)
                r = np.repeat(np.arange(szu), cu.shape[1])
                np.add.at(a, (r, cu.reshape(-1)), vu.reshape(-1))
                m += np.kron(np.eye(szd, dtype=m.dtype), a)
            if f.dn_cols is not None:
                cd = np.asarray(f.dn_cols)
                vd = np.asarray(f.dn_vals)
                a = np.zeros((szd, szd), dtype=m.dtype)
                r = np.repeat(np.arange(szd), cd.shape[1])
                np.add.at(a, (r, cd.reshape(-1)), vd.reshape(-1))
                m += np.kron(a, np.eye(szu, dtype=m.dtype))
        return m


def flatten_to_ell_host(ham, multiple: int = 1):
    """Numpy-native padded ELL flatten: (diag, cols, vals) host arrays,
    rows padded to `multiple` (self-referencing zero rows).

    Same layout as Hamiltonian.padded(multiple) but built with numpy
    memcpy-speed broadcasts instead of eager jnp ops — plan builders
    (HaloPlan) consume host arrays, and the jnp round-trip dominated
    their construction time at 1e7-dim sectors."""
    dim = ham.dim
    blocks_c, blocks_v = [], []
    if ham.factorized is not None:
        szd, szu = ham.spin_shape
        f = ham.factorized
        if f.up_cols is not None:
            cu = np.asarray(f.up_cols).astype(np.int64)
            vu = np.asarray(f.up_vals)
            ku = cu.shape[1]
            base = (np.arange(szd, dtype=np.int64) * szu)[:, None, None]
            blocks_c.append(np.ascontiguousarray(
                np.broadcast_to(cu[None], (szd, szu, ku)) + base
            ).reshape(dim, ku))
            blocks_v.append(np.ascontiguousarray(np.broadcast_to(
                vu[None], (szd, szu, ku))).reshape(dim, ku))
        if f.dn_cols is not None:
            cd = np.asarray(f.dn_cols).astype(np.int64)
            vd = np.asarray(f.dn_vals)
            kd = cd.shape[1]
            iu = np.arange(szu, dtype=np.int64)[None, :, None]
            blocks_c.append(np.ascontiguousarray(
                cd[:, None, :] * szu + iu).reshape(dim, kd))
            blocks_v.append(np.ascontiguousarray(np.broadcast_to(
                vd[:, None, :], (szd, szu, kd))).reshape(dim, kd))
    if ham.ell is not None:
        blocks_c.append(np.asarray(ham.ell.cols).astype(np.int64))
        blocks_v.append(np.asarray(ham.ell.vals))
    cols = np.concatenate(blocks_c, axis=1)
    vals = np.concatenate(blocks_v, axis=1)
    diag = np.asarray(ham.diag)
    rem = (-dim) % multiple
    if rem:
        k = cols.shape[1]
        pad_cols = np.broadcast_to(
            np.arange(dim, dim + rem, dtype=np.int64)[:, None], (rem, k))
        cols = np.concatenate([cols, pad_cols], axis=0)
        vals = np.concatenate(
            [vals, np.zeros((rem, k), vals.dtype)], axis=0)
        diag = np.concatenate([diag, np.zeros((rem,), diag.dtype)])
    return diag, cols.astype(np.int32), vals


def apply_block_t(ham, xk):
    """Apply any Hamiltonian-like object to a batch-major (k, dim)
    block: uses the object's `matmat_t` when it has one, falling back
    to vmapping its matvec (e.g. the flat factored-Heisenberg wrapper
    only defines matvec)."""
    if hasattr(ham, "matmat_t"):
        return ham.matmat_t(xk)
    return jax.vmap(ham.matvec)(xk)


def ell_spgemm(a_cols, a_vals, b_cols, b_vals):
    """Device SpGEMM for bounded-row ELL operands: C = A @ B.

    Result is ELL-with-duplicates of width Ka*Kb — exactly two gathers
    and one elementwise product on device (duplicates are legal in this
    layout: every consumer sums over the K axis).  Used for operator
    products (e.g. chaining c^dag_i c_j maps) and symmetry conjugations
    where both operands have bounded rows (the north star's SpGEMM
    primitive).
    """
    n, ka = a_cols.shape
    kb = b_cols.shape[1]
    mid_cols = a_cols                                    # (n, Ka)
    c_cols = b_cols[mid_cols].reshape(n, ka * kb)        # gather rows of B
    c_vals = (a_vals[:, :, None] *
              b_vals[mid_cols]).reshape(n, ka * kb)
    return c_cols, c_vals


def one_spin_ell(words: np.ndarray, rank_fn, bonds, dtype) -> tuple:
    """Build the one-spin hopping ELL map for a set of directed bonds.

    For each directed bond (i, j, t): rows where site i is occupied and
    site j empty hop with amplitude t * doSign(ket,i) * doSign(ket^bit_i,j)
    (reference: HubbardHelper.h:191-243 setHoppingTerm).

    Returns (cols, vals) of shape (len(words), nbonds) (padded with
    self-column, value 0).
    """
    from lanczosplusplus_tpu.core import bits

    sz = words.shape[0]
    nb = max(len(bonds), 1)
    # the native fast path computes colex ranks directly, so it only
    # applies when rank_fn is a plain combination-basis rank
    owner = getattr(rank_fn, "__self__", None)
    if (sz >= (1 << 16) and bonds and
            type(owner).__name__ == "OneSpinBasis" and
            not np.iscomplexobj(np.zeros(0, dtype))):
        from lanczosplusplus_tpu import native
        from lanczosplusplus_tpu.core.combinatorics import binomial_table
        table = binomial_table(64 + 1)
        out = native.one_spin_hop_ell(words, bonds, table)
        if out is not None:
            return out[0], out[1].astype(dtype)
    cols = np.tile(np.arange(sz, dtype=np.int64)[:, None], (1, nb))
    vals = np.zeros((sz, nb), dtype=dtype)
    for k, (i, j, t) in enumerate(bonds):
        occ_i = bits.get_bit(words, i)
        occ_j = bits.get_bit(words, j)
        ok = (occ_i == 1) & (occ_j == 0)
        sign = bits.parity_sign_below(words, i)
        mid = bits.flip_bit(words, i)
        sign = sign * bits.parity_sign_below(mid, j)
        new_words = bits.flip_bit(mid, j)
        tgt = np.where(ok, rank_fn(new_words), np.arange(sz))
        cols[:, k] = tgt
        vals[:, k] = np.where(ok, t * sign, 0).astype(dtype)
    # The reference accumulates row `ket` with column index(bra) and the
    # hop amplitude (H[ket, bra] = amp), which is already gather form:
    # y[r] = sum_k vals[r, k] * x[cols[r, k]].  The bond list carries
    # both directions, so Hermiticity is preserved.
    return cols.astype(np.int32), vals
