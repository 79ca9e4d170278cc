"""Distributed block-Kronecker (factored) Hamiltonians.

The factored forms (t-J / Rashba half-cuts, Kitaev, FeAs spin-orbit —
core/blockkron.py) are COMPUTE-bound: dense half-operator GEMMs plus a
few cut-crossing gathers, with no O(nnz) index traffic.  The device
distribution for that profile is therefore the opposite of the
gather-ELL paths: replicate the (small, O(dim)) state vector once per
matvec and shard the FLOPs —

- every block's column axis is sharded over the mesh: the row-op GEMM
  A_b @ X_b partitions over output columns with ZERO communication
  (A replicated, each device holds its column slice of X), the col-op
  GEMM X_b @ C_b^T contracts against the device's row slice of C_b,
  the diagonal and the PermCrossTerm column gathers partition the same
  way;
- the only collective is ONE all-gather of the state vector per matvec
  (42 MB at the 13-site Rashba sector),
  against fully sharded GEMMs.

This rides GSPMD: arrays are placed with the shardings above and the
matvec body pins x replicated / y row-sharded with
with_sharding_constraint; XLA inserts the all-gather and partitions
every GEMM/gather.  Drop-in for sharded_selective_solve (flat
row-sharded vectors at the boundary), so the factored models get the
full distributed solver robustness (budget/two-pass/restarts/
SolveInfo) like the flat and kron paths.

Reference has no distribution at all (SURVEY.md §2.6); this is the
scaling of its pthreads row loop for the factored representations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lanczosplusplus_tpu.core.blockkron import (BlockKronHamiltonian,
                                                PermCrossTerm)
from lanczosplusplus_tpu.parallel.mesh import ROWS
from lanczosplusplus_tpu.config import matmul_precision


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistBlockKron:
    """Column-sharded block-Kronecker matvec over `mesh`, flat
    row-sharded vectors at the boundary.  The boundary dimension is
    padded up to a mesh multiple (padded coordinates are decoupled
    zero rows, the same convention as the padded flat-ELL path)."""
    inner: BlockKronHamiltonian
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))

    @property
    def dim(self):
        ndev = self.mesh.devices.size
        d = self.inner.dim
        return d + (-d) % ndev

    @property
    def dtype(self):
        return self.inner.dtype

    def _col_sharding(self, b):
        """Column sharding for block b, or replication when its column
        count is not divisible by the mesh (tiny blocks: replicated
        compute is cheaper than padding)."""
        ndev = self.mesh.devices.size
        if self.inner.shapes[b][1] % ndev == 0:
            return NamedSharding(self.mesh, P(None, ROWS))
        return NamedSharding(self.mesh, P())

    def matvec(self, x):
        repl = NamedSharding(self.mesh, P())
        bk = self.inner
        xf = jax.lax.with_sharding_constraint(x, repl)  # all-gather
        xf = xf[:bk.dim]
        xs = bk._split(xf)
        pet = dict(preferred_element_type=x.dtype,
                   precision=matmul_precision())
        ys = []
        for b in range(len(xs)):
            yb = bk.diag[b] * xs[b]
            if bk.row_ops[b] is not None:
                yb = yb + jax.lax.dot_general(
                    bk.row_ops[b], xs[b],
                    dimension_numbers=(((1,), (0,)), ((), ())), **pet)
            if bk.col_ops[b] is not None:
                yb = yb + jax.lax.dot_general(
                    xs[b], bk.col_ops[b],
                    dimension_numbers=(((1,), (1,)), ((), ())), **pet)
            ys.append(jax.lax.with_sharding_constraint(
                yb, self._col_sharding(b)))
        for t in bk.cross:
            t1 = jnp.einsum("ndc,rc->nrd", t.right, xs[t.src], **pet)
            ys[t.dst] = ys[t.dst] + jnp.einsum(
                "nor,nrd->od", t.left, t1, **pet)
            if t.add_hc:
                t2 = jnp.einsum("rd,ndc->nrc", xs[t.dst],
                                jnp.conj(t.right), **pet)
                ys[t.src] = ys[t.src] + jnp.einsum(
                    "nor,noc->rc", jnp.conj(t.left), t2, **pet)
        for t in bk.perm_cross:
            xsrc = xs[t.src]
            acc = None
            for n in range(t.row_src.shape[0]):
                rows = xsrc[t.row_src[n]]
                term = (t.row_amp[n][:, None] * rows[:, t.col_src[n]]
                        * t.col_amp[n][None, :])
                acc = term if acc is None else acc + term
            if acc is not None:
                ys[t.dst] = ys[t.dst] + jax.lax.with_sharding_constraint(
                    acc, self._col_sharding(t.dst))
        y = jnp.concatenate(
            [jax.lax.with_sharding_constraint(yb, repl).reshape(-1)
             for yb in ys]
            + ([jnp.zeros(self.dim - bk.dim, x.dtype)]
               if self.dim > bk.dim else []))
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(self.mesh, P(ROWS)))

    def matmat_t(self, xk):
        """Batch-major SpMM for the distributed FTLM/KPM/spectral
        recurrences: replicate the block, run the inner batched apply
        (GSPMD partitions the GEMMs from the placed operand shardings),
        re-shard the result."""
        repl = NamedSharding(self.mesh, P())
        bk = self.inner
        xf = jax.lax.with_sharding_constraint(xk, repl)[:, :bk.dim]
        y = bk.matmat_t(xf)
        if self.dim > bk.dim:
            y = jnp.pad(y, ((0, 0), (0, self.dim - bk.dim)))
        return jax.lax.with_sharding_constraint(
            y, NamedSharding(self.mesh, P(None, ROWS)))


def shard_blockkron(bk: BlockKronHamiltonian,
                    mesh: Mesh) -> DistBlockKron:
    """Place a BlockKronHamiltonian for column-sharded distributed
    application: row_ops and gather index maps replicated, diagonals
    and column maps column-sharded, col_ops row-sharded (their rows
    contract against the device's column slice)."""
    ndev = mesh.devices.size
    repl = NamedSharding(mesh, P())
    col2 = NamedSharding(mesh, P(None, ROWS))
    row2 = NamedSharding(mesh, P(ROWS, None))

    def put(a, sh):
        if a is None:
            return None
        # device_put requires divisibility; tiny blocks replicate
        if sh is not repl:
            axis = 1 if sh is col2 else 0
            if a.shape[axis] % ndev != 0:
                sh = repl
        return jax.device_put(a, sh)

    # tiers (if any) are dropped: the tier stacking interleaves pad
    # columns, which breaks the uniform column sharding
    inner = dataclasses.replace(
        bk,
        tiers=None, diag_t=(), row_t=(), col_t=(),
        diag=tuple(put(d, col2) for d in bk.diag),
        row_ops=tuple(put(a, repl) for a in bk.row_ops),
        col_ops=tuple(put(a, row2) for a in bk.col_ops),
        cross=tuple(dataclasses.replace(
            t, left=put(t.left, repl), right=put(t.right, repl))
            for t in bk.cross),
        perm_cross=tuple(PermCrossTerm(
            row_src=put(t.row_src, repl), row_amp=put(t.row_amp, repl),
            col_src=put(t.col_src, col2), col_amp=put(t.col_amp, col2),
            src=t.src, dst=t.dst) for t in bk.perm_cross))
    return DistBlockKron(inner=inner, mesh=mesh)


def blockkron_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                            seed: int = 7239443, max_steps: int = 200,
                            **solve_kw):
    """Distributed lowest_states for factored forms.  Accepts a
    BlockKronHamiltonian or a PermutedHamiltonian wrapping one (solved
    in the inner block layout, like the single-chip solver; the
    eigenvectors come back in the wrapper's flat order)."""
    from lanczosplusplus_tpu.parallel.mesh import sharded_selective_solve

    wrapper = None
    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        wrapper, ham = ham, ham.inner
    sham = shard_blockkron(ham, mesh)
    out = sharded_selective_solve(sham, mesh, ham.dim, num_states,
                                  seed, max_steps, **solve_kw)
    if wrapper is None:
        return out
    evals, vecs, rest = out[0], np.asarray(out[1]), out[2:]
    if wrapper.sign is not None:
        vecs = vecs * np.asarray(wrapper.sign)[None, :]
    vecs = vecs[:, np.asarray(wrapper.inv)]
    return (evals, vecs) + rest
