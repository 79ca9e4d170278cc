"""Distributed spin-factorized (Kronecker) Hamiltonian over a mesh.

The flat row-partitioned paths (`parallel/mesh.py`, `parallel/halo.py`)
broadcast spin-separable hopping into a dim-sized ELL before sharding.
For Hubbard/FeAs/Immm sectors that layout pays O(dim*K) index traffic
and an all-gather of the whole state vector per matvec.  This module
keeps the Kronecker structure instead (reference has no distribution
at all; its pthreads row loop is HubbardHelper.h:119-133):

  X = x.reshape(size_down, size_up), sharded over rows (size_down).
  - I (x) A_up:  X @ A_up^T         -> shard-local GEMM, no comms
  - A_dn (x) I:  A_dn @ X           -> GSPMD inserts the collective
    (all-gather of X rows or a collective matmul)
  - spin-coupled remainder (FeAs U2/U3/Jpm): tiny flat ELL, gather
    triggers an x all-gather only when present

so at least half the off-diagonal FLOPs run with zero communication,
and every hot op is a GEMM.  This is the device answer to "shard
the sector rows" (SURVEY.md section 2.6) for factorizable models.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lanczosplusplus_tpu.parallel.mesh import ROWS
from lanczosplusplus_tpu.config import matmul_precision


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KronHamiltonian:
    """Sector Hamiltonian kept in Kronecker form for distribution.

    diag2d: (szd, szu) diagonal, row-sharded.
    up_dense: (szu, szu) replicated one-spin up operator.
    dn_dense: (szd, szd) down operator, rows co-sharded with output.
    ell_cols/ell_vals: optional flat spin-coupled remainder.
    """
    diag2d: jax.Array
    up_dense: Optional[jax.Array]
    dn_dense: Optional[jax.Array]
    ell_cols: Optional[jax.Array]
    ell_vals: Optional[jax.Array]

    @property
    def spin_shape(self) -> Tuple[int, int]:
        return self.diag2d.shape

    @property
    def dim(self) -> int:
        return self.diag2d.size

    @property
    def dtype(self):
        return self.diag2d.dtype

    def matvec(self, x):
        szd, szu = self.diag2d.shape
        x2d = x.reshape(szd, szu)
        y = self.diag2d * x2d
        if self.up_dense is not None:
            y = y + jax.lax.dot_general(
                x2d, self.up_dense,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=x2d.dtype,
                precision=matmul_precision())
        if self.dn_dense is not None:
            y = y + jax.lax.dot_general(
                self.dn_dense, x2d,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=x2d.dtype,
                precision=matmul_precision())
        y = y.reshape(-1)
        if self.ell_cols is not None:
            y = y + jnp.sum(self.ell_vals * x[self.ell_cols], axis=-1)
        return y

    def matmat_t(self, xk):
        """Batch-major SpMM (k, dim) -> (k, dim): the distributed
        FTLM/KPM/spectral-fleet recurrences keep their carriers in this
        layout (same contract as Hamiltonian.matmat_t).  The up-factor
        contraction folds (k, szd) into the GEMM row dimension (pure
        shard-local GEMM); only the dn factor pays a collective."""
        szd, szu = self.diag2d.shape
        k = xk.shape[0]
        x3 = xk.reshape(k, szd, szu)
        y = self.diag2d[None] * x3
        if self.up_dense is not None:
            y = y + jax.lax.dot_general(
                x3, self.up_dense,
                dimension_numbers=(((2,), (1,)), ((), ())),
                preferred_element_type=xk.dtype,
                precision=matmul_precision())
        if self.dn_dense is not None:
            t = jax.lax.dot_general(
                self.dn_dense, x3,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=xk.dtype,
                precision=matmul_precision())   # (szd, k, szu)
            y = y + jnp.transpose(t, (1, 0, 2))
        y = y.reshape(k, -1)
        if self.ell_cols is not None:
            y = y + jnp.einsum("rs,brs->br", self.ell_vals,
                               xk[:, self.ell_cols],
                               precision=matmul_precision())
        return y


def shard_kron_hamiltonian(ham, mesh: Mesh,
                           max_factor_bytes: int = 4 << 30):
    """Place a spin-factorized sector Hamiltonian on `mesh` in Kronecker
    form.  Pads size_down to a multiple of the mesh size (flat indices
    of existing entries are unchanged: rows append at the top).
    """
    if ham.factorized is None:
        raise ValueError("Hamiltonian has no spin-factorized part")
    h = ham.densify_factors(max_bytes=max_factor_bytes)
    f = h.factorized
    if f.up_dense is None or f.dn_dense is None:
        raise ValueError("factors too large to densify for the "
                         "distributed Kronecker path")
    szd, szu = h.spin_shape
    ndev = mesh.devices.size
    pad = (-szd) % ndev
    diag2d = np.asarray(h.diag).reshape(szd, szu)
    dn = np.asarray(f.dn_dense)
    if pad:
        diag2d = np.vstack([diag2d, np.zeros((pad, szu), diag2d.dtype)])
        dn2 = np.zeros((szd + pad, szd + pad), dn.dtype)
        dn2[:szd, :szd] = dn
        dn = dn2
    row2d = NamedSharding(mesh, P(ROWS, None))
    repl = NamedSharding(mesh, P())
    ell_cols = ell_vals = None
    if h.ell is not None:
        cols = np.asarray(h.ell.cols)
        vals = np.asarray(h.ell.vals)
        if pad:
            k = cols.shape[1]
            extra = np.tile(np.arange(szd * szu, (szd + pad) * szu,
                                      dtype=cols.dtype)[:, None], (1, k))
            cols = np.vstack([cols, extra])
            vals = np.vstack([vals, np.zeros((pad * szu, k), vals.dtype)])
        ell_cols = jax.device_put(jnp.asarray(cols), row2d)
        ell_vals = jax.device_put(jnp.asarray(vals), row2d)
    return KronHamiltonian(
        diag2d=jax.device_put(jnp.asarray(diag2d), row2d),
        up_dense=jax.device_put(f.up_dense, repl),
        dn_dense=jax.device_put(jnp.asarray(dn), row2d),
        ell_cols=ell_cols, ell_vals=ell_vals), szd * szu


def kron_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                       seed: int = 7239443, max_steps: int = 200,
                       **solve_kw):
    """Distributed lowest_states in Kronecker form: the same selective
    Lanczos scan as the single-chip solver, with the Krylov basis and
    state vector sharded over the mesh rows.  Extra keywords (tol,
    krylov_budget_bytes, return_info, strict) reach
    sharded_selective_solve."""
    from lanczosplusplus_tpu.parallel.mesh import sharded_selective_solve

    kham, _ = shard_kron_hamiltonian(ham, mesh)
    return sharded_selective_solve(kham, mesh, ham.dim, num_states,
                                   seed, max_steps, **solve_kw)
