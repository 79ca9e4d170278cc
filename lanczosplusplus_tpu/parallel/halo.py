"""Halo-exchange distributed SpMV.

The naive row-sharded matvec lets XLA all-gather the full state vector
(O(dim) communication per device).  ED Hamiltonians touch only a
bounded set of off-shard columns per row, so the communication can be
the *halo*: for each (owner, consumer) device pair, the unique state
entries the consumer's rows read from the owner's shard
(SURVEY.md §7 item 8: "all-gather/all-to-all of vector halo segments
... overlapped with local SpMV").

`HaloPlan` precomputes, host-side, from the ELL column structure:
- per-device send index lists (what I ship to each peer), padded to the
  global max so `lax.all_to_all` has a static shape;
- remapped ELL columns into the concatenated
  [local shard | halo buffer] index space.

`halo_matvec` is a `shard_map` whose only collective is one
all-to-all of the halo values; the local gather has no data dependence
on the exchange, so the compiler is FREE to overlap them — whether it
does is backend-dependent and was checked, not assumed: on the CPU
emulation mesh the compiled module runs a single SYNCHRONOUS
all-to-all (no async start/done pair — no overlap; the CPU mesh is a
correctness vehicle), and a 1-device plan compiles the exchange away
entirely.  Overlap on a real multi-card mesh is the latency-hiding
scheduler's decision and is not measured yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from lanczosplusplus_tpu.parallel.mesh import ROWS
from lanczosplusplus_tpu.config import matmul_precision


class HaloPlan:
    def __init__(self, ham, ndev: int):
        from lanczosplusplus_tpu.core.sparse import flatten_to_ell_host

        diag, cols, vals = flatten_to_ell_host(ham, ndev)
        dim = diag.shape[0]
        shard = dim // ndev

        # Fully vectorized plan construction (no per-nonzero Python and
        # no global sort): a (ndev, dim) needed-column bitmask is built
        # with one scatter pass per ELL slot, then the per-consumer
        # unique remote columns fall out of np.nonzero already sorted
        # (hence grouped by owner, since owner = col // shard).  An
        # int32 (ndev, dim) remap table turns the column remapping into
        # one gather pass per slot.  Slots that never leave their shard
        # (e.g. the up-spin Kronecker slots, block-diagonal by
        # construction) are detected with one cheap compare pass and
        # skip both the bitmask scatter and the remap gather.
        # O(nnz) work, O(ndev * dim) memory.
        kslots = cols.shape[1]
        row_dev = (np.arange(dim, dtype=np.int64) // shard).astype(
            np.int32)
        local_lo = row_dev.astype(np.int64) * shard
        remote_slots = []
        need = np.zeros((ndev, dim), dtype=bool)
        for kk in range(kslots):
            c = cols[:, kk].astype(np.int64)
            off = c - local_lo
            if ((off >= 0) & (off < shard)).all():
                continue                       # slot is all-local
            remote_slots.append(kk)
            need[row_dev, c] = True
        for d in range(ndev):
            need[d, d * shard:(d + 1) * shard] = False

        halo_sizes = np.zeros((ndev, ndev), dtype=np.int64)
        remap = np.empty((ndev, dim), dtype=np.int32) \
            if remote_slots else None
        uniq_per_dev = [np.nonzero(need[d])[0] for d in range(ndev)]
        for d in range(ndev):
            halo_sizes[d] = np.bincount(uniq_per_dev[d] // shard,
                                        minlength=ndev)
        maxcount = max(int(halo_sizes.max(initial=0)), 1)

        # halo buffer layout per consumer: ndev slots of maxcount each
        # (slot s holds what owner s sent; own slot unused)
        send_idx = np.zeros((ndev, ndev, maxcount), dtype=np.int32)
        for d in range(ndev):
            uniq = uniq_per_dev[d]
            u_s = (uniq // shard).astype(np.int64)
            starts = np.searchsorted(u_s, np.arange(ndev))
            pos = np.arange(uniq.shape[0]) - starts[u_s]
            if remap is not None:
                remap[d] = np.arange(dim, dtype=np.int32) - d * shard
                remap[d, uniq] = shard + u_s * maxcount + pos
            send_idx[u_s, d, pos] = (uniq - u_s * shard).astype(np.int32)

        new_cols = (cols.astype(np.int64) - local_lo[:, None]).astype(
            np.int32)
        for kk in remote_slots:
            new_cols[:, kk] = remap[row_dev, cols[:, kk]]
        self.ndev = ndev
        self.shard = shard
        self.maxcount = maxcount
        self.dim = dim
        self.orig_dim = ham.dim
        self.new_cols = new_cols.astype(np.int32)
        self.vals = vals
        self.diag = diag
        self.send_idx = send_idx
        # communication volume relative to an all-gather of x
        # (which moves dim * (ndev - 1) values in total)
        self.halo_fraction = float(halo_sizes.sum()) / \
            max(dim * (ndev - 1), 1)

    def device_arrays(self, mesh: Mesh):
        row = NamedSharding(mesh, P(ROWS, None))
        vec = NamedSharding(mesh, P(ROWS))
        first = NamedSharding(mesh, P(ROWS, None, None))
        return dict(
            diag=jax.device_put(jnp.asarray(self.diag), vec),
            cols=jax.device_put(jnp.asarray(self.new_cols), row),
            vals=jax.device_put(jnp.asarray(self.vals), row),
            send_idx=jax.device_put(jnp.asarray(self.send_idx), first),
        )

    def hamiltonian(self, mesh: Mesh) -> "HaloHamiltonian":
        arrays = self.device_arrays(mesh)
        return HaloHamiltonian(diag=arrays["diag"], cols=arrays["cols"],
                               vals=arrays["vals"],
                               send_idx=arrays["send_idx"], mesh=mesh)

    def matvec_fn(self, mesh: Mesh):
        def halo_matvec(diag, cols, vals, send_idx, x):
            # shard-local shapes: diag/x (shard,), cols/vals (shard, K),
            # send_idx (1, ndev, maxcount)
            send = x[send_idx[0]]                      # (ndev, maxcount)
            recv = jax.lax.all_to_all(send, ROWS, 0, 0)
            halo = recv.reshape(-1)                    # ndev*maxcount
            combined = jnp.concatenate([x, halo])
            return diag * x + jnp.sum(vals * combined[cols], axis=-1)

        spec_row = P(ROWS, None)
        fn = shard_map(halo_matvec, mesh=mesh,
                       in_specs=(P(ROWS), spec_row, spec_row,
                                 P(ROWS, None, None), P(ROWS)),
                       out_specs=P(ROWS))
        return jax.jit(fn)


import dataclasses


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloHamiltonian:
    """Hamiltonian whose matvec is the halo-exchange shard_map; drops
    into the same Lanczos scan as the single-chip Hamiltonian."""
    diag: jax.Array
    cols: jax.Array
    vals: jax.Array
    send_idx: jax.Array
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))

    @property
    def dim(self):
        return self.diag.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    def matvec(self, x):
        def halo_matvec(diag, cols, vals, send_idx, x):
            send = x[send_idx[0]]
            recv = jax.lax.all_to_all(send, ROWS, 0, 0)
            combined = jnp.concatenate([x, recv.reshape(-1)])
            return diag * x + jnp.sum(vals * combined[cols], axis=-1)

        spec_row = P(ROWS, None)
        fn = shard_map(halo_matvec, mesh=self.mesh,
                       in_specs=(P(ROWS), spec_row, spec_row,
                                 P(ROWS, None, None), P(ROWS)),
                       out_specs=P(ROWS))
        return fn(self.diag, self.cols, self.vals, self.send_idx, x)


class KronHaloPlan:
    """Halo exchange for spin-factorized Hamiltonians, planned on the
    (size_down, Kd) dn factor alone.

    Shards align to whole dn rows (size_down padded to a multiple of
    ndev, like parallel/kron.py), so the up-spin Kronecker part is
    shard-local by construction and the only remote data are whole
    szu-wide dn rows: the all-to-all moves contiguous (max_rows, szu)
    tiles, the dn gather reads contiguous rows, and the plan costs O(size_down * Kd) host work — no
    O(nnz) index array is ever materialized, on host or device.

    A spin-coupled flat-ELL remainder (FeAs U2/U3/Jpm terms that no
    spin factorization can carry; reference FeBasedSc.h
    setU2OffDiagonalTerm/setU3Term) rides a SECOND scalar all-to-all
    planned on its own column structure — so INT_PAPER33 sectors get
    the cheap whole-row dn exchange for the hopping while only the
    small remainder pays an entry-wise halo, instead of falling back
    to the minutes-to-plan generic flat HaloPlan (VERDICT r2 item 7).
    """

    def __init__(self, ham, ndev: int):
        f = ham.factorized
        if f is None or f.dn_cols is None:
            raise ValueError("KronHaloPlan needs a spin-factorized "
                             "Hamiltonian with a dn factor")
        szd, szu = ham.spin_shape
        pad = (-szd) % ndev
        szd_p = szd + pad
        d_shard = szd_p // ndev
        cd = np.asarray(f.dn_cols).astype(np.int64)
        vd = np.asarray(f.dn_vals)
        if pad:
            cd = np.vstack([cd, np.broadcast_to(
                np.arange(szd, szd_p, dtype=np.int64)[:, None],
                (pad, cd.shape[1]))])
            vd = np.vstack([vd, np.zeros((pad, vd.shape[1]), vd.dtype)])
        kd = cd.shape[1]
        row_dev = np.arange(szd_p, dtype=np.int64) // d_shard

        # unique remote dn rows per consumer device (sorted => grouped
        # by owner, owner = dn_row // d_shard)
        need = np.zeros((ndev, szd_p), dtype=bool)
        for kk in range(kd):
            need[row_dev, cd[:, kk]] = True
        for d in range(ndev):
            need[d, d * d_shard:(d + 1) * d_shard] = False
        halo_rows = np.zeros((ndev, ndev), dtype=np.int64)
        uniq_per_dev = [np.nonzero(need[d])[0] for d in range(ndev)]
        for d in range(ndev):
            halo_rows[d] = np.bincount(uniq_per_dev[d] // d_shard,
                                       minlength=ndev)
        max_rows = max(int(halo_rows.max(initial=0)), 1)

        # dn-row remap: local -> dn_row - D*d_shard; remote ->
        # d_shard + s*max_rows + pos (position in owner-s's sent tile)
        remap = np.empty((ndev, szd_p), dtype=np.int32)
        send_rows = np.zeros((ndev, ndev, max_rows), dtype=np.int32)
        for d in range(ndev):
            uniq = uniq_per_dev[d]
            u_s = uniq // d_shard
            starts = np.searchsorted(u_s, np.arange(ndev))
            pos = np.arange(uniq.shape[0]) - starts[u_s]
            remap[d] = np.arange(szd_p, dtype=np.int32) - d * d_shard
            remap[d, uniq] = d_shard + u_s * max_rows + pos
            send_rows[u_s, d, pos] = (uniq - u_s * d_shard).astype(
                np.int32)
        ncd = remap[row_dev[:, None], cd]              # (szd_p, Kd)

        # -- optional spin-coupled flat remainder: entry-wise halo ----
        # planned on the remainder's own column structure (its nnz is
        # small by construction — it is what the factorization could
        # not carry), so the O(nnz) scatter pass here is cheap
        rem_cols = rem_vals = rem_send = None
        halo_entries = 0
        if ham.ell is not None:
            fshard = d_shard * szu
            dimp = szd_p * szu
            rc = np.asarray(ham.ell.cols).astype(np.int64)
            rv = np.asarray(ham.ell.vals)
            if pad:
                kr = rc.shape[1]
                rc = np.vstack([rc, np.broadcast_to(
                    np.arange(szd * szu, dimp,
                              dtype=np.int64)[:, None],
                    (pad * szu, kr))])
                rv = np.vstack([rv,
                                np.zeros((pad * szu, kr), rv.dtype)])
            frow_dev = np.arange(dimp, dtype=np.int64) // fshard
            rneed = np.zeros((ndev, dimp), dtype=bool)
            for kk in range(rc.shape[1]):
                rneed[frow_dev, rc[:, kk]] = True
            for d in range(ndev):
                rneed[d, d * fshard:(d + 1) * fshard] = False
            halo_ent = np.zeros((ndev, ndev), dtype=np.int64)
            runiq = [np.nonzero(rneed[d])[0] for d in range(ndev)]
            for d in range(ndev):
                halo_ent[d] = np.bincount(runiq[d] // fshard,
                                          minlength=ndev)
            max_ent = max(int(halo_ent.max(initial=0)), 1)
            rremap = np.empty((ndev, dimp), dtype=np.int32)
            rem_send = np.zeros((ndev, ndev, max_ent), dtype=np.int32)
            for d in range(ndev):
                uniq = runiq[d]
                u_s = uniq // fshard
                starts = np.searchsorted(u_s, np.arange(ndev))
                posn = np.arange(uniq.shape[0]) - starts[u_s]
                rremap[d] = (np.arange(dimp, dtype=np.int64)
                             - d * fshard).astype(np.int32)
                rremap[d, uniq] = (fshard + u_s * max_ent
                                   + posn).astype(np.int32)
                rem_send[u_s, d, posn] = (uniq - u_s * fshard).astype(
                    np.int32)
            rem_cols = rremap[frow_dev[:, None], rc].astype(np.int32)
            rem_vals = rv
            halo_entries = int(halo_ent.sum())

        diag = np.asarray(ham.diag).reshape(szd, szu)
        if pad:
            diag = np.vstack([diag, np.zeros((pad, szu), diag.dtype)])
        self.ndev = ndev
        self.spin_shape = (szd_p, szu)
        self.d_shard = d_shard
        self.max_rows = max_rows
        self.dim = szd_p * szu
        self.orig_dim = ham.dim
        self.diag2d = diag
        self.ncd = ncd
        self.vd = vd
        self.up_cols = None if f.up_cols is None else \
            np.asarray(f.up_cols)
        self.up_vals = None if f.up_vals is None else \
            np.asarray(f.up_vals)
        self.up_dense = None if f.up_dense is None else \
            np.asarray(f.up_dense)
        self.send_rows = send_rows
        self.rem_cols = rem_cols
        self.rem_vals = rem_vals
        self.rem_send = rem_send
        self.halo_fraction = \
            float(halo_rows.sum() * szu + halo_entries) / \
            max(self.dim * (ndev - 1), 1)

    def hamiltonian(self, mesh: Mesh) -> "KronHaloHamiltonian":
        row = NamedSharding(mesh, P(ROWS, None))
        first = NamedSharding(mesh, P(ROWS, None, None))
        repl = NamedSharding(mesh, P())
        up_dense = self.up_dense
        if up_dense is None and self.up_cols is not None:
            # densify the local up factor (it is tiny relative to the
            # sector and turns the local hot loop into a GEMM)
            szu = self.spin_shape[1]
            a = np.zeros((szu, szu), self.up_vals.dtype)
            r = np.repeat(np.arange(szu), self.up_cols.shape[1])
            np.add.at(a, (r, self.up_cols.reshape(-1)),
                      self.up_vals.reshape(-1))
            up_dense = a
        return KronHaloHamiltonian(
            diag2d=jax.device_put(jnp.asarray(self.diag2d), row),
            up_dense=None if up_dense is None else
            jax.device_put(jnp.asarray(up_dense), repl),
            ncd=jax.device_put(jnp.asarray(self.ncd), row),
            vd=jax.device_put(jnp.asarray(self.vd), row),
            send_rows=jax.device_put(jnp.asarray(self.send_rows), first),
            rem_cols=None if self.rem_cols is None else
            jax.device_put(jnp.asarray(self.rem_cols), row),
            rem_vals=None if self.rem_vals is None else
            jax.device_put(jnp.asarray(self.rem_vals), row),
            rem_send=None if self.rem_send is None else
            jax.device_put(jnp.asarray(self.rem_send), first),
            mesh=mesh)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KronHaloHamiltonian:
    """Spin-factorized halo Hamiltonian: local up-factor GEMM + one
    all-to-all of whole dn rows + contiguous-row dn gather, plus (when
    a spin-coupled ELL remainder exists) one scalar all-to-all for the
    remainder's off-shard entries.  Drops into the same Lanczos scan
    as the single-chip Hamiltonian."""
    diag2d: jax.Array        # (szd_p, szu) row-sharded
    up_dense: jax.Array      # (szu, szu) replicated (or None)
    ncd: jax.Array           # (szd_p, Kd) remapped dn rows
    vd: jax.Array            # (szd_p, Kd)
    send_rows: jax.Array     # (ndev, ndev, max_rows)
    rem_cols: Optional[jax.Array] = None  # (szd_p*szu, Kr) remapped
    rem_vals: Optional[jax.Array] = None  # (szd_p*szu, Kr)
    rem_send: Optional[jax.Array] = None  # (ndev, ndev, max_ent)
    mesh: Mesh = dataclasses.field(metadata=dict(static=True),
                                   default=None)

    @property
    def dim(self):
        return self.diag2d.shape[0] * self.diag2d.shape[1]

    @property
    def dtype(self):
        return self.vd.dtype

    def matvec(self, x):
        szu = self.diag2d.shape[1]

        def body(diag2d, up_dense, ncd, vd, send_rows,
                 rem_cols, rem_vals, rem_send, x):
            x2d = x.reshape(-1, szu)                   # (d_shard, szu)
            send = x2d[send_rows[0]]                   # (ndev, mr, szu)
            recv = jax.lax.all_to_all(send, ROWS, 0, 0)
            combined = jnp.concatenate(
                [x2d, recv.reshape(-1, szu)], axis=0)
            y = diag2d * x2d
            if up_dense is not None:
                y = y + jax.lax.dot_general(
                    x2d, up_dense,
                    dimension_numbers=(((1,), (1,)), ((), ())),
                    preferred_element_type=x2d.dtype,
                    precision=matmul_precision())
            for k in range(vd.shape[1]):
                y = y + vd[:, k, None] * combined[ncd[:, k], :]
            if rem_cols is not None:
                send_r = x[rem_send[0]]                # (ndev, max_ent)
                recv_r = jax.lax.all_to_all(send_r, ROWS, 0, 0)
                combf = jnp.concatenate([x, recv_r.reshape(-1)])
                y = y + jnp.sum(rem_vals * combf[rem_cols],
                                axis=-1).reshape(-1, szu)
            return y.reshape(-1)

        row = P(ROWS, None)
        first = P(ROWS, None, None)
        fn = shard_map(body, mesh=self.mesh,
                       in_specs=(row, P(), row, row, first,
                                 row, row, first, P(ROWS)),
                       out_specs=P(ROWS))
        return fn(self.diag2d, self.up_dense, self.ncd, self.vd,
                  self.send_rows, self.rem_cols, self.rem_vals,
                  self.rem_send, x)


def halo_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                       seed: int = 7239443, max_steps: int = 200,
                       **solve_kw):
    """Distributed lowest_states with halo-exchange communication
    instead of a full all-gather (Kronecker-structured halo when the
    Hamiltonian factorizes, generic flat-ELL halo otherwise).  Extra
    keywords (tol, krylov_budget_bytes, return_info, strict) reach
    sharded_selective_solve."""
    from lanczosplusplus_tpu.parallel.mesh import sharded_selective_solve

    if getattr(ham, "factorized", None) is not None and \
            ham.factorized.dn_cols is not None:
        plan = KronHaloPlan(ham, mesh.devices.size)
        sham = plan.hamiltonian(mesh)
        return sharded_selective_solve(sham, mesh, plan.orig_dim,
                                       num_states, seed, max_steps,
                                       **solve_kw)
    return _halo_lowest_states_flat(ham, mesh, num_states, seed,
                                    max_steps, **solve_kw)


def _halo_lowest_states_flat(ham, mesh: Mesh, num_states: int = 1,
                             seed: int = 7239443, max_steps: int = 200,
                             **solve_kw):
    """Generic flat-ELL halo solve."""
    from lanczosplusplus_tpu.parallel.mesh import sharded_selective_solve

    plan = HaloPlan(ham, mesh.devices.size)
    sham = plan.hamiltonian(mesh)
    return sharded_selective_solve(sham, mesh, plan.orig_dim,
                                   num_states, seed, max_steps,
                                   **solve_kw)
