"""Row-partitioned distribution of sector Hamiltonians over a device mesh.

The reference's only hot-loop parallelism is a pthreads parallel-for
over Hilbert-space rows of the matrix-free apply (reference:
src/Models/HubbardOneOrbital/HubbardHelper.h:119-133,
src/Engine/ProgramGlobals.h via Parallelizer2).  The device scaling
of the same axis: ELL rows, the diagonal and the state vector are
1-D sharded over a `jax.sharding.Mesh`; the column gather x[cols] makes
XLA insert an all-gather of the state vector, and Lanczos
scalars (vdot, norm) become sharded reductions (psum).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lanczosplusplus_tpu.config import matmul_precision

ROWS = "rows"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (ROWS,))


def shard_hamiltonian(ham, mesh: Mesh):
    """Pad + ELL-flatten a Hamiltonian and place rows across the mesh."""
    h = ham.padded(mesh.devices.size)
    row_sharded = NamedSharding(mesh, P(ROWS, None))
    vec_sharded = NamedSharding(mesh, P(ROWS))
    from lanczosplusplus_tpu.core.sparse import EllPart, Hamiltonian
    return Hamiltonian(
        diag=jax.device_put(h.diag, vec_sharded),
        ell=EllPart(cols=jax.device_put(h.ell.cols, row_sharded),
                    vals=jax.device_put(h.ell.vals, row_sharded)),
        factorized=None, spin_shape=None)


def sharded_vector(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P(ROWS)))


def shard_for_mesh(ham, mesh: Mesh, prefer_kron: bool = True):
    """Place a sector Hamiltonian on `mesh` in its best distributed
    form: Kronecker (parallel/kron.py — shard-local GEMM for the
    up factor, one collective for the down factor) whenever the
    Hamiltonian has densifiable spin factors, else the padded flat ELL
    (all-gather of x per matvec).  Block-factorized forms
    (BlockKronHamiltonian / PermutedHamiltonian) go column-sharded via
    parallel/blockkron_dist.py.  This is the production dispatch for
    every distributed driver below."""
    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        ham = ham.inner     # solve factored forms in block layout
    if hasattr(ham, "shapes"):
        from lanczosplusplus_tpu.parallel.blockkron_dist import \
            shard_blockkron
        return shard_blockkron(ham, mesh)
    if prefer_kron and getattr(ham, "factorized", None) is not None:
        from lanczosplusplus_tpu.parallel.kron import \
            shard_kron_hamiltonian
        try:
            kham, _ = shard_kron_hamiltonian(ham, mesh)
            return kham
        except ValueError:
            pass  # factors too large to densify: fall through to ELL
    return shard_hamiltonian(ham, mesh)


def _sharded_plain_solve(sham, mesh: Mesh, v0, orig_dim: int,
                         num_states: int, max_steps: int):
    """Distributed plain two-pass Lanczos: O(2 vectors) of sharded
    memory — the fallback when the stored Krylov basis would blow the
    byte budget (north-star config 5: 1e8-1e9 nnz sectors whose V at
    200 steps exceeds per-chip HBM).  First pass builds (alpha, beta)
    with the sharded three-term recurrence, host eigensolve, second
    pass replays the recurrence accumulating the Ritz vectors — both
    passes reuse the single-chip jitted scans, which GSPMD re-lowers
    with the mesh shardings of their operands."""
    from lanczosplusplus_tpu.solver import lanczos as lz

    dtype = v0.dtype
    rdt = jnp.float64 if dtype in (jnp.float64, jnp.complex128) \
        else jnp.float32
    steps = int(min(orig_dim, max_steps))
    zero = jnp.zeros_like(v0)
    beta0 = jnp.asarray(0.0, rdt)
    _, _, _, alphas, betas = lz._lanczos_chunk_plain(
        sham, v0, zero, beta0, jnp.arange(steps))
    alphas, betas, m = lz.trim_at_breakdown(alphas, betas)
    evals, evecs = lz.tridiag_eigh(alphas[:m], betas[:m])
    k = min(num_states, m)
    vecs = []
    for i in range(k):
        wts = np.zeros(steps)
        wts[:m] = evecs[:, i]
        acc = lz._lanczos_accumulate_pass(
            sham, v0, zero, beta0, jnp.asarray(wts),
            jnp.zeros_like(v0), jnp.arange(steps))
        acc = acc / jnp.linalg.norm(acc)
        vecs.append(np.asarray(acc)[:orig_dim])
    return evals[:k], np.asarray(vecs)


def sharded_selective_solve(sham, mesh: Mesh, orig_dim: int,
                            num_states: int, seed: int, max_steps: int,
                            tol: float = 1e-10,
                            krylov_budget_bytes: int = 6 << 30,
                            return_info: bool = False,
                            strict: bool = False):
    """Shared distributed lowest_states driver: run the selective-
    reorthogonalization Lanczos scan on an already-sharded Hamiltonian
    (flat ELL, halo or Kronecker form — anything with .dim/.dtype/
    .matvec), with the Krylov basis and state vector row-sharded over
    `mesh`; finish with the common epilogue.  Padded coordinates carry
    zero start amplitude and never enter the Krylov space.

    Carries the single-chip solver's robustness machinery
    (solver/lanczos.py lowest_states; reference Engine.h:616-639):
    when the stored (steps, dim) Krylov basis would exceed
    `krylov_budget_bytes` PER MESH (the basis is row-sharded, so the
    per-device share is budget/ndev), the memory-light distributed
    plain two-pass solver takes over; otherwise the Ritz residual is
    checked and steps double (within budget) until convergence, with
    memory-bounded single-state restarts at the budget edge.  Returns
    (evals, vecs) or (evals, vecs, SolveInfo) with `return_info=True`;
    `strict=True` raises on non-convergence instead of returning
    silently."""
    from lanczosplusplus_tpu.solver import lanczos as lz
    from lanczosplusplus_tpu.solver.lanczos import SolveInfo

    def ret(evals, vecs, info):
        return (evals, vecs, info) if return_info else (evals, vecs)

    dim = sham.dim
    dtype = sham.dtype
    itemsize = np.dtype(dtype).itemsize
    v0 = lz.random_start_vector(orig_dim, seed, dtype)
    v0 = jnp.concatenate([jnp.asarray(v0),
                          jnp.zeros(dim - orig_dim, dtype=dtype)])
    v0 = sharded_vector(v0, mesh)
    if jnp.dtype(dtype) in (jnp.float32, jnp.complex64):
        tol = max(tol, 1e-6)

    if min(orig_dim, max_steps) * dim * itemsize > krylov_budget_bytes:
        evals, vecs = _sharded_plain_solve(sham, mesh, v0, orig_dim,
                                           num_states, max_steps)
        # no stored basis to estimate a residual from; extremal Ritz
        # values converge first (standard plain-Lanczos theory)
        return ret(evals, vecs, SolveInfo(True, float("nan"),
                                          min(orig_dim, max_steps)))

    steps = int(min(orig_dim, max_steps))
    Vsharding = NamedSharding(mesh, P(None, ROWS))
    restarts = 0
    while True:
        V = jax.device_put(jnp.zeros((steps, dim), dtype=dtype),
                           Vsharding)
        state = lz._selective_init_state(v0, steps)
        V, state, alphas, betas, _ = lz._lanczos_chunk_selective(
            sham, V, state, jnp.arange(steps))
        a_t, b_t, m = lz.trim_at_breakdown(alphas, betas)
        evals, evecs = lz.tridiag_eigh(a_t[:m], b_t[:m])
        k_chk = min(num_states, m)
        resid = abs(b_t[m - 1]) * np.abs(evecs[m - 1, :k_chk]).max()
        scale = max(np.abs(evals[0]), 1.0)
        converged = bool(m < steps or steps >= orig_dim or
                         resid <= tol * scale)
        if converged or steps >= 4 * max_steps:
            break
        if 2 * steps * dim * itemsize > krylov_budget_bytes:
            if num_states > 1 or restarts >= 8:
                break
            # memory-bounded restart from the current Ritz vector
            restarts += 1
            w = jnp.asarray(np.vstack([evecs[:, :1],
                                       np.zeros((steps - m, 1))]),
                            dtype=V.dtype)
            v_r = jnp.matmul(V.T, w,
                             precision=matmul_precision())[:, 0]
            v0 = v_r / jnp.linalg.norm(v_r)
            continue
        steps = int(min(orig_dim, steps * 2))
    if not converged and strict:
        raise RuntimeError(
            f"distributed Lanczos failed to converge: relative residual "
            f"{resid / scale:.3e} > tol {tol:.1e} after {steps} steps "
            f"at dim {orig_dim}")
    evals, vecs = lz.finish_lanczos(alphas, betas, V, num_states)
    return ret(evals, np.asarray(vecs)[:, :orig_dim],
               SolveInfo(converged, resid / scale, steps))


def lanczos_step(ham, v, v_prev, beta_prev):
    """One distributed Lanczos iteration (matvec + alpha/beta): the unit
    the multi-chip dry run compiles and executes."""
    w = ham.matvec(v)
    alpha = jnp.real(jnp.vdot(v, w))
    w = w - alpha * v - beta_prev * v_prev
    # re-orthogonalize against current vector once more (local Gram step)
    w = w - jnp.vdot(v, w) * v
    beta = jnp.linalg.norm(w)
    v_next = w / jnp.where(beta > 0, beta, 1.0)
    return v_next, v, alpha, beta


def jit_lanczos_step(mesh: Mesh):
    vec = NamedSharding(mesh, P(ROWS))
    none = NamedSharding(mesh, P())
    return jax.jit(
        lanczos_step,
        out_shardings=(vec, vec, none, none))


def distributed_lowest_states(ham, mesh: Mesh, num_states: int = 1,
                              seed: int = 7239443, max_steps: int = 200,
                              prefer_kron: bool = True, **solve_kw):
    """Row-sharded computeAllStatesBelow over a device mesh.

    Spin-factorizable Hamiltonians run in distributed Kronecker form
    (shard-local GEMM for the up factor; only the down factor pays
    a collective); block-factorized forms (BlockKronHamiltonian or a
    PermutedHamiltonian wrapping one) run column-sharded with the
    state replicated per matvec (parallel/blockkron_dist.py); others
    pad + flatten to ELL, where XLA inserts the x all-gather for the
    column gather.  Lanczos scalars are psum reductions either way.
    Returns (energies, vectors) with vectors trimmed back to the
    unpadded dimension."""
    if hasattr(ham, "shapes") or (hasattr(ham, "inner")
                                  and hasattr(ham, "perm")):
        from lanczosplusplus_tpu.parallel.blockkron_dist import \
            blockkron_lowest_states
        return blockkron_lowest_states(ham, mesh, num_states, seed,
                                       max_steps, **solve_kw)
    sham = shard_for_mesh(ham, mesh, prefer_kron=prefer_kron)
    return sharded_selective_solve(sham, mesh, ham.dim, num_states,
                                   seed, max_steps, **solve_kw)


def _padded_random_block(dim, dimp, num_vectors, dtype, seed, mesh):
    """(dimp, R) random start block: normalized columns over the TRUE
    dim, zero in the padded rows (padded rows are decoupled eigenvalue-0
    states; nonzero start amplitude there would contaminate trace
    estimators), placed row-sharded."""
    from lanczosplusplus_tpu.solver.lanczos import random_start_block

    v = random_start_block(dim, num_vectors, seed, dtype)
    v = jnp.pad(v, ((0, dimp - dim), (0, 0)))
    return jax.device_put(v, NamedSharding(mesh, P(ROWS, None)))


def distributed_ftlm(ham, mesh: Mesh, beta_grid, num_vectors: int = 32,
                     steps: int = 80, seed: int = 982451653,
                     operators=None):
    """Finite-temperature Lanczos with the sector row-sharded over the
    mesh: each batched-recurrence step is a sharded SpMM (XLA inserts
    the state-block all-gather) and the per-column scalars are
    psum reductions.  Diagonal operators (1-D arrays) are padded
    automatically; matmat-style operator objects at the unpadded
    sector dimension (e.g. the Hamiltonian itself) are sharded+padded
    too (_pad_operators)."""
    from lanczosplusplus_tpu.engine.ftlm import ftlm

    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # factored wrapper: run in block layout (traces are basis-
        # independent); permute diagonal operators into it
        perm = np.asarray(ham.perm)
        if operators:
            operators = {
                k: (op if hasattr(op, "matmat")
                    or hasattr(op, "matmat_t")
                    else np.asarray(op)[perm])
                for k, op in operators.items()}
        ham = ham.inner
    sham = shard_for_mesh(ham, mesh)
    dim, dimp = ham.dim, sham.dim
    V0 = _padded_random_block(dim, dimp, num_vectors, sham.dtype,
                              seed, mesh)
    ops = (_pad_operators(operators, ham, sham, mesh)
           if operators else None)
    return ftlm(sham, beta_grid, steps=steps, start_vectors=V0,
                trace_dim=dim, operators=ops)


def _pad_operators(operators, ham, sham, mesh):
    """Operator dict for the padded/sharded estimators: diagonal
    arrays are zero-padded to the mesh dimension; matmat-style
    operator objects still sized at the UNPADDED sector dimension
    (e.g. the Hamiltonian itself, for <H>/<H^2> observables) are
    sharded+padded the same way as the estimator's Hamiltonian;
    already-padded objects pass through."""
    dim, dimp = ham.dim, sham.dim
    ops = {}
    for name, op in operators.items():
        if hasattr(op, "matmat") or hasattr(op, "matmat_t"):
            if op is ham:
                op = sham
            elif getattr(op, "dim", dimp) == dim and dim != dimp:
                op = shard_for_mesh(op, mesh)
            ops[name] = op
        else:
            diag = np.asarray(op)
            ops[name] = jnp.pad(jnp.asarray(diag),
                                (0, dimp - diag.shape[0]))
    return ops


def distributed_ltlm(ham, mesh: Mesh, beta_grid, operators,
                     num_vectors: int = 16, steps: int = 80,
                     seed: int = 982451653):
    """Low-temperature Lanczos (the symmetric estimator of
    engine/ftlm.ltlm) with the sector row-sharded over the mesh: each
    stored-V Lanczos run and each (M, dim)x(dim, M) operator-projection
    GEMM runs with sharded operands (GSPMD inserts the collectives),
    padded rows carry zero start amplitude.  Same ham/operator
    conventions as distributed_ftlm."""
    from lanczosplusplus_tpu.engine.ftlm import ltlm

    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        perm = np.asarray(ham.perm)
        operators = {
            k: (op if hasattr(op, "matmat") or hasattr(op, "matmat_t")
                else np.asarray(op)[perm])
            for k, op in operators.items()}
        ham = ham.inner
    sham = shard_for_mesh(ham, mesh)
    dim, dimp = ham.dim, sham.dim
    V0 = _padded_random_block(dim, dimp, num_vectors, sham.dtype,
                              seed, mesh)
    ops = _pad_operators(operators, ham, sham, mesh)
    return ltlm(sham, beta_grid, ops, steps=steps, start_vectors=V0,
                trace_dim=dim)


def distributed_spectral_fleet(ham, mesh: Mesh, v0s, steps: int = 100):
    """Batched continued-fraction tridiagonalizations (the spectral-
    function fleet of Engine.spectral_functions_batched) with the
    destination sector row-sharded over the mesh: each block step is a
    sharded SpMM, per-vector alpha/beta are psum reductions.  v0s is
    the (R, dim) block of normalized op|gs> start vectors; padded
    coordinates (decoupled zero-eigenvalue rows) carry zero start
    amplitude and never enter the Krylov space, so the returned
    tridiagonals equal the single-device ones.  Returns the list of
    per-vector LanczosResult for ContinuedFraction assembly."""
    from lanczosplusplus_tpu.solver.lanczos import \
        tridiagonalize_plain_batched

    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # factored wrapper: start vectors arrive in flat order —
        # convert into the block layout (tridiagonals are invariant)
        v0s = np.asarray(v0s)[:, np.asarray(ham.perm)]
        if ham.sign is not None:
            v0s = v0s * np.asarray(ham.sign)[None, :]
        ham = ham.inner
    sham = shard_for_mesh(ham, mesh)
    dim, dimp = ham.dim, sham.dim
    v0s = jnp.asarray(np.asarray(v0s), dtype=sham.dtype)
    v0s = jnp.pad(v0s, ((0, 0), (0, dimp - dim)))
    v0s = jax.device_put(v0s, NamedSharding(mesh, P(None, ROWS)))
    return tridiagonalize_plain_batched(sham, v0s, steps)


def _perm_layout(ham):
    """(to_block, to_flat, inner) converters for an optionally
    PermutedHamiltonian-wrapped sector Hamiltonian.  block = sign *
    flat[perm]; flat = (sign * block)[inv] (core/blockkron.py
    conventions, matching lowest_states' eigenvector conversion)."""
    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        perm = np.asarray(ham.perm)
        inv = np.asarray(ham.inv)
        sign = np.asarray(ham.sign) if ham.sign is not None else None

        def to_block(x):
            xb = np.asarray(x)[perm]
            return xb * sign if sign is not None else xb

        def to_flat(xb):
            xb = np.asarray(xb)
            if sign is not None:
                xb = xb * sign
            return xb[inv]

        return to_block, to_flat, ham.inner

    def ident(x):
        return np.asarray(x)

    return ident, ident, ham


def distributed_ftlm_dynamic(ham_src, ham_dst, apply_b, mesh: Mesh,
                             num_vectors: int = 16, steps: int = 100,
                             seed: int = 152917, apply_a=None,
                             start_vectors=None):
    """FTLM double-Krylov finite-T dynamics (engine/ftlm_dynamic.py)
    with BOTH sector Hamiltonians row-sharded over the mesh: every
    stored-V tridiagonalization runs on sharded operands (GSPMD
    re-lowers the jitted scans with the mesh shardings) and the cross
    coupling GEMM contracts the sharded Krylov blocks.  apply_b /
    apply_a keep the single-device convention (unpadded numpy vectors
    in FLAT order); padding and any factored-form block-layout
    conversion happen here.  Padded rows carry zero start amplitude,
    so the returned pole data equals the single-device estimator's."""
    import dataclasses

    from lanczosplusplus_tpu.engine.ftlm_dynamic import ftlm_dynamic
    from lanczosplusplus_tpu.solver.lanczos import random_start_block

    apply_a = apply_a or apply_b
    src_tb, src_tf, src_inner = _perm_layout(ham_src)
    dst_tb, _, dst_inner = _perm_layout(ham_dst)
    s_src = shard_for_mesh(src_inner, mesh)
    s_dst = shard_for_mesh(dst_inner, mesh)
    dim_s, dimp_s = src_inner.dim, s_src.dim
    dim_d, dimp_d = dst_inner.dim, s_dst.dim

    if start_vectors is not None:
        V0 = np.asarray(start_vectors)             # flat order
    else:
        V0 = np.asarray(random_start_block(
            ham_src.dim, num_vectors, seed, ham_src.dtype))
    V0b = np.stack([src_tb(V0[:, r]) for r in range(V0.shape[1])],
                   axis=1)
    V0b = np.pad(V0b, ((0, dimp_s - dim_s), (0, 0)))

    def wrap(apply):
        def f(v):      # padded block src -> padded block dst
            y = apply(src_tf(np.asarray(v)[:dim_s]))
            return np.pad(dst_tb(y), (0, dimp_d - dim_d))
        return f

    res = ftlm_dynamic(s_src, s_dst, wrap(apply_b), steps=steps,
                       apply_a=wrap(apply_a), start_vectors=V0b)
    return dataclasses.replace(res, dim=ham_src.dim)


def distributed_kpm_dos(ham, mesh: Mesh, num_moments: int = 256,
                        num_vectors: int = 16, seed: int = 314159,
                        bounds=None):
    """Stochastic-trace density of states by the kernel polynomial
    method with the sector row-sharded over the mesh (the Chebyshev
    recurrence's SpMM runs sharded; padded rows carry zero amplitude
    and the trace is normalized by the TRUE dimension)."""
    from lanczosplusplus_tpu.engine.kpm import (chebyshev_moments,
                                                spectral_bounds)

    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        ham = ham.inner     # traces are basis-independent
    sham = shard_for_mesh(ham, mesh)
    dim, dimp = ham.dim, sham.dim
    if bounds is None:
        bounds = spectral_bounds(sham)
    V0 = _padded_random_block(dim, dimp, num_vectors, sham.dtype,
                              seed, mesh)
    res = chebyshev_moments(sham, V0, num_moments, bounds=bounds)
    res.moments *= dim / num_vectors
    return res
