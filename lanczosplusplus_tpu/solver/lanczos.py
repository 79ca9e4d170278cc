"""Lanczos tridiagonalization with full reorthogonalization.

Device replacement for PsimagLite::LanczosSolver as the reference
uses it (reference: src/Engine/Engine.h:601-657 computeAllStatesBelow,
Engine.h:460-490 decomposition for spectral functions).

Design: one `lax.scan` over Lanczos steps; the Krylov basis V is a
dense (steps, dim) array carried through the scan, so full
reorthogonalization is two GEMVs against V — unfilled rows are zero and
contribute nothing, keeping shapes static.  The (alpha, beta)
tridiagonal is tiny and solved on host.  V rows are sharded the same
way as the state vector, so reorthogonalization runs as sharded
matmul + psum when the Hamiltonian is row-partitioned over a mesh.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import scipy.linalg
import jax
import jax.numpy as jnp

from lanczosplusplus_tpu.config import matmul_precision


def _reorth_pass(V, w):
    """One classical Gram-Schmidt pass of w against the rows of V.

    V may be stored in a lower precision than w (e.g. bfloat16): the
    two GEMVs then read half the bytes — the dominant memory traffic
    of a reorthogonalized Lanczos step — while the result stays in the
    compute dtype."""
    if V.dtype != w.dtype:
        coeffs = jax.lax.dot_general(
            jnp.conj(V), w.astype(V.dtype),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=w.dtype, precision=matmul_precision())
        return w - jax.lax.dot_general(
            V, coeffs.astype(V.dtype),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=w.dtype, precision=matmul_precision())
    coeffs = jnp.matmul(jnp.conj(V), w, precision=matmul_precision())
    return w - jnp.matmul(V.T, coeffs, precision=matmul_precision())


@partial(jax.jit, donate_argnums=(1,))
def _lanczos_chunk(ham, V, v, js):
    """Run len(js) Lanczos steps continuing from (V, v); js are the
    global step indices written into V.

    V may be stored in a lower precision than v (e.g. bfloat16): the
    reorthogonalization GEMVs then read half the bytes — the dominant
    memory traffic of a Lanczos step — while alpha/beta and the state
    vector stay in the compute dtype.  Low-precision V degrades
    orthogonality to ~1e-3 and is only for throughput-oriented runs.
    """

    reorth_pass = lambda V, w: _reorth_pass(V, w)

    def body(carry, j):
        V, v = carry
        V = V.at[j].set(v.astype(V.dtype))
        w = ham.matvec(v)
        alpha = jnp.real(jnp.vdot(v, w))
        # full reorthogonalization with the DGKS criterion: always one
        # pass; a second pass only when the first collapsed the norm
        # (eta = 1/sqrt(2)), which is when classical Gram-Schmidt loses
        # orthogonality (e.g. near Krylov-space exhaustion).  The
        # conditional saves the dominant V-read traffic on typical steps.
        norm0 = jnp.linalg.norm(w)
        w = reorth_pass(V, w)
        norm1 = jnp.linalg.norm(w)
        w = jax.lax.cond(norm1 < 0.7071 * norm0,
                         lambda ww: reorth_pass(V, ww),
                         lambda ww: ww, w)
        beta = jnp.linalg.norm(w)
        safe = jnp.where(beta > 0, beta, 1.0)
        v_next = jnp.where(beta > 0, w / safe, jnp.zeros_like(w))
        return (V, v_next), (alpha, beta)

    (V, v), (alphas, betas) = jax.lax.scan(body, (V, v), js)
    return V, v, alphas, betas


@partial(jax.jit, donate_argnums=(1,))
def _lanczos_chunk_selective(ham, V, state, js):
    """Run len(js) Lanczos steps with *selective* reorthogonalization
    (Simon's omega-recurrence).  The scan carries a running estimate
    omega[i] ~ <v_k, v_i> of the orthogonality loss against every
    stored Krylov vector, updated each step from the three-term
    coefficients alone (O(steps) work).  Only when max|omega| crosses
    the threshold does the step pay the two full-V GEMV passes that
    full reorthogonalization pays every step; the following step is
    reorthogonalized too (the classic pairwise rule), then the
    estimates reset to the noise floor.  Typical steps therefore cost
    one matvec + two AXPYs — the plain-Lanczos rate — while Ritz
    values keep full-reorth accuracy (semiorthogonality is sufficient:
    Simon 1984; reference solver reorthogonalizes fully every step,
    PsimagLite LanczosSolver as used at Engine.h:609-626).
    """
    v, v_prev, beta_prev, omega, omega_prev, a_hist, b_hist, force = state
    rdt = omega.dtype
    eps = float(max(jnp.finfo(V.dtype).eps, jnp.finfo(v.dtype).eps))
    eta = eps ** (2.0 / 3.0)      # trigger threshold
    eps1 = 10.0 * eps             # per-step noise floor of the estimate

    def do_reorth(Vc, ww):
        n0 = jnp.linalg.norm(ww)
        ww = _reorth_pass(Vc, ww)
        n1 = jnp.linalg.norm(ww)
        return jax.lax.cond(n1 < 0.7071 * n0,
                            lambda x: _reorth_pass(Vc, x),
                            lambda x: x, ww)

    def body(carry, j):
        (V, v, v_prev, beta_prev, omega, omega_prev,
         a_hist, b_hist, force) = carry
        V = V.at[j].set(v.astype(V.dtype))
        w = ham.matvec(v)
        alpha = jnp.real(jnp.vdot(v, w)).astype(rdt)
        w = w - alpha.astype(w.dtype) * v \
            - beta_prev.astype(w.dtype) * v_prev
        a_hist = a_hist.at[j].set(alpha)
        beta0 = jnp.linalg.norm(w).astype(rdt)

        # omega recurrence:  beta_k * omega_{k+1,i} =
        #   b_i*omega_{k,i+1} + (a_i - a_k)*omega_{k,i}
        #   + b_{i-1}*omega_{k,i-1} - b_{k-1}*omega_{k-1,i}
        # (b[i] couples steps i and i+1).
        omega_k = omega.at[j].set(1.0)           # omega_{k,k} = 1
        om_plus = jnp.roll(omega_k, -1).at[-1].set(0.0)
        om_minus = jnp.roll(omega_k, 1).at[0].set(0.0)
        b_minus = jnp.roll(b_hist, 1).at[0].set(0.0)
        num = (b_hist * om_plus + (a_hist - alpha) * omega_k
               + b_minus * om_minus - beta_prev * omega_prev)
        safe_b0 = jnp.maximum(beta0, jnp.asarray(1e-30, rdt))
        idx = jnp.arange(omega.shape[0])
        om_new = num / safe_b0
        om_new = om_new + jnp.where(om_new >= 0, eps1, -eps1)
        om_new = jnp.where(idx < j, om_new, 0.0)
        om_new = om_new.at[j].set(eps1)          # omega_{k+1,k}: local orth

        need = jnp.logical_or(force,
                              jnp.max(jnp.abs(om_new)) > eta)
        w = jax.lax.cond(need, do_reorth, lambda Vc, x: x, V, w)
        om_new = jnp.where(need,
                           jnp.where(idx <= j, eps1, 0.0), om_new)
        force_next = jnp.logical_and(need, jnp.logical_not(force))

        beta = jnp.linalg.norm(w).astype(rdt)
        b_hist = b_hist.at[j].set(beta)
        safe = jnp.maximum(beta, jnp.asarray(1e-30, rdt))
        v_next = jnp.where(beta > 0, w / safe.astype(w.dtype),
                           jnp.zeros_like(w))
        carry = (V, v_next, v, beta, om_new, omega_k,
                 a_hist, b_hist, force_next)
        return carry, (alpha, beta, need)

    init = (V, v, v_prev, beta_prev, omega, omega_prev,
            a_hist, b_hist, force)
    carry, (alphas, betas, reorthed) = jax.lax.scan(body, init, js)
    V = carry[0]
    state = carry[1:]
    return V, state, alphas, betas, reorthed


def _selective_init_state(v0, steps: int):
    rdt = jnp.float64 if v0.dtype in (jnp.float64, jnp.complex128) \
        else jnp.float32
    z = jnp.zeros((steps,), rdt)
    return (v0, jnp.zeros_like(v0), jnp.asarray(0.0, rdt),
            z, z, z, z, jnp.asarray(False))


def _lanczos_scan(ham, v0, steps: int, checkpoint=None, chunk=None,
                  reorth_dtype=None, reorth="selective"):
    """Full run with optional chunked checkpointing: the Krylov basis,
    (alpha, beta) and the current vector are persisted to
    `checkpoint`.npz after each chunk and restored on restart — the
    resume capability the reference lacks (SURVEY.md section 5).

    reorth='selective' (default) pays the full-V Gram-Schmidt passes
    only when the omega-recurrence estimate crosses threshold;
    reorth='full' pays them every step (the reference's policy)."""
    dim = v0.shape[0]
    dtype = v0.dtype
    selective = reorth == "selective"
    V = jnp.zeros((steps, dim), reorth_dtype or dtype)
    state = _selective_init_state(v0, steps)
    v = v0
    alphas = []
    betas = []
    nreorth = 0
    start = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        data = np.load(checkpoint)
        saved_mode = str(data["mode"]) if "mode" in data.files else "full"
        if (int(data["steps"]) == steps and int(data["dim"]) == dim and
                saved_mode == reorth):
            start = int(data["next_step"])
            V = jnp.asarray(data["V"])
            v = jnp.asarray(data["v"])
            alphas = list(data["alphas"])
            betas = list(data["betas"])
            if selective:
                state = (v, jnp.asarray(data["s_vprev"]),
                         jnp.asarray(data["s_betaprev"]),
                         jnp.asarray(data["s_omega"]),
                         jnp.asarray(data["s_omegaprev"]),
                         jnp.asarray(data["s_ahist"]),
                         jnp.asarray(data["s_bhist"]),
                         jnp.asarray(bool(data["s_force"])))
    chunk = chunk or (steps if checkpoint is None else max(steps // 8, 1))
    j = start
    while j < steps:
        n = min(chunk, steps - j)
        if selective:
            V, state, a, b, re = _lanczos_chunk_selective(
                ham, V, state, jnp.arange(j, j + n))
            v = state[0]
            nreorth += int(np.asarray(re).sum())
        else:
            V, v, a, b = _lanczos_chunk(ham, V, v, jnp.arange(j, j + n))
        alphas.extend(np.asarray(a))
        betas.extend(np.asarray(b))
        j += n
        if checkpoint is not None:
            extra = {}
            if selective:
                extra = dict(s_vprev=np.asarray(state[1]),
                             s_betaprev=np.asarray(state[2]),
                             s_omega=np.asarray(state[3]),
                             s_omegaprev=np.asarray(state[4]),
                             s_ahist=np.asarray(state[5]),
                             s_bhist=np.asarray(state[6]),
                             s_force=np.asarray(state[7]))
            np.savez(checkpoint,
                     V=np.asarray(V), v=np.asarray(v),
                     alphas=np.asarray(alphas), betas=np.asarray(betas),
                     next_step=j, steps=steps, dim=dim, mode=reorth,
                     **extra)
    return (V, jnp.asarray(np.asarray(alphas)),
            jnp.asarray(np.asarray(betas)), nreorth)


@jax.jit
def _lanczos_chunk_plain(ham, v, v_prev, beta_prev, js):
    """Memory-light three-term Lanczos (no stored Krylov basis, no
    reorthogonalization).  O(2 vectors) memory enables Hilbert
    dimensions far beyond what a stored (steps, dim) basis allows —
    the pod-scale configuration (BASELINE.json config 5).  Ghost
    eigenvalues appear as orthogonality decays; extremal eigenvalues
    converge regardless (standard plain-Lanczos behavior)."""

    def body(carry, j):
        v, v_prev, beta_prev = carry
        w = ham.matvec(v)
        alpha = jnp.real(jnp.vdot(v, w))
        w = w - alpha * v - beta_prev * v_prev
        beta = jnp.linalg.norm(w)
        safe = jnp.where(beta > 0, beta, 1.0)
        v_next = jnp.where(beta > 0, w / safe, jnp.zeros_like(w))
        return (v_next, v, beta), (alpha, beta)

    (v, v_prev, beta), (alphas, betas) = jax.lax.scan(
        body, (v, v_prev, beta_prev), js)
    return v, v_prev, beta, alphas, betas


@jax.jit
def _lanczos_accumulate_pass(ham, v, v_prev, beta_prev, weights, acc, js):
    """Second pass of two-pass Lanczos: replay the recurrence and
    accumulate sum_j weights[j] v_j into acc."""

    def body(carry, jw):
        v, v_prev, beta_prev, acc = carry
        j, wgt = jw
        acc = acc + wgt * v
        w = ham.matvec(v)
        alpha = jnp.real(jnp.vdot(v, w))
        w = w - alpha * v - beta_prev * v_prev
        beta = jnp.linalg.norm(w)
        safe = jnp.where(beta > 0, beta, 1.0)
        v_next = jnp.where(beta > 0, w / safe, jnp.zeros_like(w))
        return (v_next, v, beta, acc), None

    (v, v_prev, beta, acc), _ = jax.lax.scan(
        body, (v, v_prev, beta_prev, acc),
        (js, weights.astype(v.dtype)))
    return acc


def lowest_states_plain(ham, num_states: int = 1, seed: int = 7239443,
                        max_steps: int = 300, v0=None):
    """Ground/low states via plain two-pass Lanczos: first pass builds
    (alpha, beta) with O(2 vectors) memory, host eigensolve, second
    pass replays the recurrence to accumulate the Ritz vectors."""
    dim = ham.dim
    dtype = ham.dtype
    steps = int(min(dim, max_steps))
    if v0 is None:
        v0 = random_start_vector(dim, seed, dtype)
    else:
        v0 = jnp.asarray(v0, dtype)
        v0 = v0 / jnp.linalg.norm(v0)
    zero = jnp.zeros_like(v0)
    v, vp, beta, alphas, betas = _lanczos_chunk_plain(
        ham, v0, zero, jnp.asarray(0.0, jnp.float64
                                   if dtype in (jnp.float64,
                                                jnp.complex128)
                                   else jnp.float32),
        jnp.arange(steps))
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    evals, evecs = tridiag_eigh(alphas[:m], betas[:m])
    k = min(num_states, m)
    vecs = []
    for i in range(k):
        wts = np.zeros(steps)
        wts[:m] = evecs[:, i]
        acc = _lanczos_accumulate_pass(
            ham, v0, zero,
            jnp.asarray(0.0, jnp.float64
                        if dtype in (jnp.float64, jnp.complex128)
                        else jnp.float32),
            jnp.asarray(wts), jnp.zeros_like(v0), jnp.arange(steps))
        acc = acc / jnp.linalg.norm(acc)
        vecs.append(acc)
    return evals[:k], vecs


def tridiagonalize_plain(ham, v0, steps: int):
    """(alphas, betas) via the memory-light recurrence — enough for
    continued-fraction spectral functions, which never need the Krylov
    basis itself."""
    steps = int(min(steps, v0.shape[0]))
    rdt = jnp.float64 if v0.dtype in (jnp.float64, jnp.complex128) \
        else jnp.float32
    v, vp, beta, alphas, betas = _lanczos_chunk_plain(
        ham, v0, jnp.zeros_like(v0), jnp.asarray(0.0, rdt),
        jnp.arange(steps))
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    return LanczosResult(alphas=alphas[:m], betas=betas[:m], V=None, m=m)


@partial(jax.jit, static_argnums=(2,))
def _plain_batched_recurrence(ham, V0, steps):
    """Batched memory-light Lanczos over the ROWS of V0 (R, dim): every
    step is one batched SpMM (`apply_block_t`, dense Kronecker factors
    as GEMMs) plus per-row axpy/dots — the same shape as
    the FTLM recurrence.  Returns (alphas, betas) of shape (steps, R).
    Rows whose recurrence breaks down carry zero vectors onward, so
    their trailing (alpha, beta) are zero."""
    from lanczosplusplus_tpu.core.sparse import apply_block_t

    rdt = jnp.float64 if V0.dtype in (jnp.float64, jnp.complex128) \
        else jnp.float32

    def body(carry, _):
        V, V_prev, beta_prev = carry
        W = apply_block_t(ham, V)
        alpha = jnp.real(jnp.sum(jnp.conj(V) * W, axis=1)).astype(rdt)
        W = W - alpha[:, None].astype(W.dtype) * V \
            - beta_prev[:, None].astype(W.dtype) * V_prev
        beta = jnp.sqrt(jnp.sum(jnp.abs(W) ** 2, axis=1)).astype(rdt)
        safe = jnp.where(beta > 0, beta, 1.0).astype(W.dtype)
        V_next = jnp.where((beta > 0)[:, None], W / safe[:, None],
                           jnp.zeros_like(W))
        return (V_next, V, beta), (alpha, beta)

    init = (V0, jnp.zeros_like(V0), jnp.zeros((V0.shape[0],), rdt))
    _, (alphas, betas) = jax.lax.scan(body, init, None, length=steps)
    return alphas, betas


def tridiagonalize_plain_batched(ham, v0s, steps: int):
    """R tridiagonalizations sharing one sector Hamiltonian as ONE
    batched SpMM recurrence — the device shape for continued-
    fraction fleets (all site pairs / operator types of a spectral-
    function run that land in the same sector run together instead of
    one Lanczos dispatch per pair; reference: Engine.h:460-490 runs
    each decomposition serially).

    v0s: (R, dim) with unit-norm rows.  Returns a list of R
    LanczosResult (V=None), each trimmed at its own breakdown."""
    v0s = jnp.asarray(v0s)
    steps = int(min(steps, v0s.shape[1]))
    alphas, betas = _plain_batched_recurrence(ham, v0s, steps)
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    out = []
    for r in range(v0s.shape[0]):
        a, b, m = trim_at_breakdown(alphas[:, r], betas[:, r])
        out.append(LanczosResult(alphas=a[:m], betas=b[:m], V=None, m=m))
    return out


def trim_at_breakdown(alphas, betas):
    """(alphas, betas, m): float64 copies of the tridiagonal plus the
    effective step count m before Lanczos breakdown (an invariant
    subspace was found; beta underflowed relative to the coefficient
    scale).  Shared by every solver epilogue."""
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    steps = len(alphas)
    scale = max(np.abs(alphas).max(initial=0.0),
                np.abs(betas).max(initial=0.0), 1.0)
    m = steps
    for j in range(steps - 1):
        if betas[j] <= 1e-12 * scale:
            m = j + 1
            break
    return alphas, betas, m


def finish_lanczos(alphas, betas, V, num_states: int):
    """Shared Lanczos epilogue: trim the tridiagonal at breakdown,
    eigensolve it on host, and assemble the `num_states` normalized
    Ritz vectors from the stored Krylov basis V (steps, dim) — used by
    the single-chip solver and all distributed drivers (plain
    all-gather, halo, Kronecker).  Returns (evals[:k], vecs (k, dim))."""
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    evals, evecs = tridiag_eigh(alphas[:m], betas[:m])
    k = min(num_states, m)
    steps = V.shape[0]
    w = jnp.asarray(np.vstack([evecs[:, :k],
                               np.zeros((steps - m, k))]), dtype=V.dtype)
    vecs = jnp.matmul(V.T, w, precision=matmul_precision()).T
    vecs = vecs / jnp.linalg.norm(vecs, axis=1, keepdims=True)
    return evals[:k], vecs


@dataclass
class LanczosResult:
    alphas: np.ndarray   # (m,)
    betas: np.ndarray    # (m,)  beta[j] couples step j to j+1
    V: jax.Array         # (steps, dim) Krylov basis (rows >= m are zero)
    m: int               # effective number of steps before breakdown


def tridiagonalize(ham, v0, steps: int, checkpoint=None,
                   chunk=None, reorth_dtype=None,
                   reorth="selective") -> LanczosResult:
    """Run `steps` Lanczos iterations from normalized v0 (optionally
    checkpointed/resumable; optionally with a low-precision Krylov
    basis, see _lanczos_scan)."""
    steps = int(min(steps, v0.shape[0]))
    V, alphas, betas, _ = _lanczos_scan(ham, v0, steps,
                                        checkpoint=checkpoint,
                                        chunk=chunk,
                                        reorth_dtype=reorth_dtype,
                                        reorth=reorth)
    alphas, betas, m = trim_at_breakdown(alphas, betas)
    return LanczosResult(alphas=alphas[:m], betas=betas[:m], V=V, m=m)


def tridiag_eigh(alphas: np.ndarray, betas: np.ndarray):
    """Host eigensolve of the Lanczos tridiagonal (replaces LAPACK via
    PsimagLite ground-state extraction)."""
    if len(alphas) == 1:
        return alphas.copy(), np.ones((1, 1))
    return scipy.linalg.eigh_tridiagonal(alphas, betas[:len(alphas) - 1])


def ritz_vectors(res: LanczosResult, weights: np.ndarray) -> jax.Array:
    """Columns of weights (m, k) combined over the Krylov basis."""
    w = jnp.asarray(
        np.vstack([weights, np.zeros((res.V.shape[0] - res.m,
                                      weights.shape[1]))]),
        res.V.dtype)
    return jnp.matmul(res.V.T, w, precision=matmul_precision()).T


def random_start_block(dim: int, num: int, seed: int, dtype) -> jax.Array:
    """Deterministic random (dim, num) block with unit-norm columns —
    the shared start-vector generator for Lanczos, FTLM and KPM.

    Components are ALWAYS generated in float32 and cast, so the same
    (dim, num, seed) yields the same stochastic sample at every
    precision: an f32 run and an f64 golden then differ only by
    arithmetic rounding, not by a resampled estimator.  (jax.random
    consumes different bit counts per dtype; generating in the target
    dtype made the round-4 FTLM 'f32 error' field actually measure
    R=24 stochastic spread — 7.6e-3 — while the true f32-vs-f64
    pipeline deviation on identical start vectors is ~8e-9.)"""
    key = jax.random.PRNGKey(seed)
    if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
        k1, k2 = jax.random.split(key)
        real_dt = jnp.float64 if jnp.dtype(dtype) == jnp.complex128 \
            else jnp.float32
        v = jax.lax.complex(
            jax.random.normal(k1, (dim, num), jnp.float32)
            .astype(real_dt),
            jax.random.normal(k2, (dim, num), jnp.float32)
            .astype(real_dt)).astype(dtype)
    else:
        v = jax.random.normal(key, (dim, num), jnp.float32) \
            .astype(dtype)
    return v / jnp.linalg.norm(v, axis=0, keepdims=True)


def random_start_vector(dim: int, seed: int, dtype) -> jax.Array:
    """Deterministic random start (reference: Engine.h:620-621 uses
    PsimagLite::Random48 fillRandom)."""
    return random_start_block(dim, 1, seed, dtype)[:, 0]


@dataclass
class SolveInfo:
    """Convergence report of a lowest_states solve (the reference logs
    Lanczos failure and falls back to dense, Engine.h:624-639; this
    carries the equivalent machine-readable state)."""
    converged: bool
    residual: float          # a-posteriori Ritz residual (relative)
    steps: int               # Lanczos steps actually run
    used_dense_fallback: bool = False
    # set by Engine when SolverOptions=factored degraded to the flat
    # gather path; None when the factored form was used or was never
    # requested
    factored_fallback: str | None = None
    refine_seconds: float = 0.0   # wall time of the energy refinement


def _dense_solve(ham, num_states: int):
    dense = ham.to_dense()
    # eigh in f64 regardless of the stored dtype: np.linalg.eigh
    # preserves the input dtype, and an f32 eigensolve floors tiny
    # sectors at ~1e-8 relative even when H's entries are exact in f32
    dense = dense.astype(np.complex128 if np.iscomplexobj(dense)
                         else np.float64)
    evals, evecs = np.linalg.eigh(dense)
    k = min(num_states, dense.shape[0])
    # host vectors (tiny); callers convert if they need device
    return evals[:k], evecs[:, :k].T.copy()


def _maybe_refine(ham, evals, vecs):
    """Low-precision energy refinement (reference bar: f64,
    LanczosDriver.h:29-33).  Real flat forms evaluate the Rayleigh
    quotient in on-chip df64 (error-free transformations over the
    gather maps); block-Kronecker / permuted factored forms and complex
    scalars — whose hot op is a GEMM with rounded accumulation, so
    no chip EFT route exists — fall back to ONE host float64 matvec per
    state (exact f64, off the hot path), capped by a flop budget so the
    automatic path never stalls minutes on a huge factored sector."""
    dt = jnp.dtype(getattr(ham, "dtype", np.float64))
    quantized = getattr(ham, "quantized", False)
    if dt not in (jnp.float32, jnp.complex64) and not quantized:
        return evals
    from lanczosplusplus_tpu.ops import df64
    is_flat_real = (dt == jnp.float32 and hasattr(ham, "ell")
                    and hasattr(ham, "diag")
                    and not hasattr(ham, "shapes"))
    try:
        if is_flat_real:
            # all on chip: df64 residuals + f32 GMRES corrections, no
            # flop cap at any dimension
            return np.array([df64.chip_rqi_refined_energy(
                ham, np.asarray(v)) for v in vecs])
        flops = df64.refinement_flops(ham)
        if flops * 4 * len(vecs) <= 1.5e12:
            # full RQI: ~4 host f64 matvecs per state
            return np.array([df64.rqi_refined_energy(ham, np.asarray(v))
                             for v in vecs])
        if flops * len(vecs) <= 4e11:
            # single host-f64 Rayleigh quotient (quadratic error only)
            return np.array([df64.host_refined_energy(ham, np.asarray(v))
                             for v in vecs])
    except NotImplementedError:
        pass
    return evals


# share of the device's allocatable memory a stored Krylov basis may
# take: the rest holds the Hamiltonian (dense one-spin factors up to
# 2 GiB each), the scan's working vectors and the refinement's
# 21-vector GMRES basis
KRYLOV_MEMORY_FRACTION = 0.5


def default_krylov_budget_bytes(device=None) -> int:
    """Byte budget of the stored Krylov basis: a fixed share of what
    the device's allocator may hand out (`memory_stats()["bytes_limit"]`),
    or 6 GiB where the device reports no limit (the CPU backend)."""
    device = device if device is not None else jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return 6 << 30
    return int(KRYLOV_MEMORY_FRACTION * limit)


def lowest_states(ham, num_states: int = 1, seed: int = 7239443,
                  max_steps: int = 200, tol: float = 1e-10,
                  krylov_budget_bytes: int | None = None,
                  reorth="selective", return_info: bool = False,
                  dense_fallback_dim: int = 8192,
                  strict: bool = False, refine: bool = True,
                  v0=None):
    """Lowest `num_states` eigenpairs of a sector Hamiltonian.

    Equivalent to LanczosSolver::computeAllStatesBelow as driven by
    Engine::computeAllStatesBelow (reference: Engine.h:616-626), with
    the dense-diagonalization fallback folded in for tiny sectors AND
    as the failure path: if the Lanczos step-doubling loop ends with
    the Ritz residual still above tol, the sector is fully
    diagonalized when `dim <= dense_fallback_dim` (reference:
    Engine.h:624-639 catches the solver throw and calls fullDiag);
    otherwise the unconverged result is returned with
    `SolveInfo.converged=False` (or raised when `strict`).  When the
    stored Krylov basis would exceed `krylov_budget_bytes` (default:
    `default_krylov_budget_bytes()`), the memory-light plain two-pass
    solver takes over (huge sectors).

    Returns (evals, vecs) — or (evals, vecs, SolveInfo) with
    `return_info=True`.
    """
    def ret(evals, vecs, info):
        return (evals, vecs, info) if return_info else (evals, vecs)

    if krylov_budget_bytes is None:
        krylov_budget_bytes = default_krylov_budget_bytes()

    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # PermutedHamiltonian: solve in the INNER (block) layout and
        # convert only the returned eigenvectors: the flat wrap would
        # add whole-dim random perm gathers to every matvec, and the
        # spectrum is basis-independent.
        if v0 is not None:
            v0 = np.asarray(v0)[np.asarray(ham.perm)]
            if ham.sign is not None:
                v0 = v0 * np.asarray(ham.sign)
        evals, vecs, info = lowest_states(
            ham.inner, num_states=num_states, seed=seed,
            max_steps=max_steps, tol=tol,
            krylov_budget_bytes=krylov_budget_bytes, reorth=reorth,
            return_info=True, dense_fallback_dim=dense_fallback_dim,
            strict=strict, refine=refine, v0=v0)
        vecs = np.asarray(vecs)
        if ham.sign is not None:
            vecs = vecs * np.asarray(ham.sign)[None, :]
        return ret(evals, vecs[:, np.asarray(ham.inv)], info)

    dim = ham.dim
    dtype = ham.dtype
    if dim <= max(64, num_states + 2):
        evals, vecs = _dense_solve(ham, num_states)
        return ret(evals, vecs, SolveInfo(True, 0.0, 0, True))
    itemsize = np.dtype(dtype).itemsize
    if min(dim, max_steps) * dim * itemsize > krylov_budget_bytes:
        evals, vecs = lowest_states_plain(
            ham, num_states=num_states, seed=seed, max_steps=max_steps,
            v0=v0)
        jax.block_until_ready(vecs)
        t0 = time.perf_counter()
        if refine:
            evals = _maybe_refine(ham, evals, vecs)
        # the plain path has no stored basis to estimate a residual
        # from; extremal Ritz values converge first (standard theory)
        return ret(evals, vecs, SolveInfo(
            True, float("nan"), min(dim, max_steps),
            refine_seconds=time.perf_counter() - t0))

    if v0 is None:
        v0 = random_start_vector(dim, seed, dtype)
    else:
        v0 = jnp.asarray(v0, dtype)
        v0 = v0 / jnp.linalg.norm(v0)
    steps = int(min(dim, max_steps))
    if jnp.dtype(dtype) in (jnp.float32, jnp.complex64):
        tol = max(tol, 1e-6)
    if getattr(ham, "quantized", False):
        # quantized (bf16-state-cast) matvecs break the selective
        # omega recurrence's exact-three-term assumption — its silent
        # orthogonality collapse produces garbage Ritz values; full
        # reorthogonalization is noise-robust
        reorth = "full"
        tol = max(tol, 1e-3)
    restarts = 0
    while True:
        res = tridiagonalize(ham, v0, steps, reorth=reorth)
        evals, evecs = tridiag_eigh(res.alphas, res.betas)
        # a-posteriori Ritz residual estimate: |beta_m * u[last]|
        # (standard Lanczos bound) for the requested states
        k_chk = min(num_states, res.m)
        resid = abs(res.betas[res.m - 1]) * \
            np.abs(evecs[res.m - 1, :k_chk]).max()
        scale = max(np.abs(evals[0]), 1.0)
        converged = bool(res.m < steps or steps >= dim or
                         resid <= tol * scale)
        if converged or steps >= 4 * max_steps:
            break
        # not converged: extend, but never past the Krylov-basis
        # memory budget (the stored V doubles with the steps);
        # at the budget, RESTART from the current Ritz vector instead
        # (memory-bounded restarted Lanczos) — single-state only
        if 2 * steps * dim * itemsize > krylov_budget_bytes:
            if num_states > 1 or restarts >= 8:
                break
            restarts += 1
            v_r = ritz_vectors(res, evecs[:, :1])[0]
            v0 = v_r / jnp.linalg.norm(v_r)
            res = None      # free this basis before the next is built
            continue
        res = None
        steps = int(min(dim, steps * 2))
    if not converged:
        if dim <= dense_fallback_dim and hasattr(ham, "to_dense"):
            evals, vecs = _dense_solve(ham, num_states)
            return ret(evals, vecs,
                       SolveInfo(True, resid / scale, steps, True))
        if strict:
            raise RuntimeError(
                f"Lanczos failed to converge: relative residual "
                f"{resid / scale:.3e} > tol {tol:.1e} after {steps} "
                f"steps at dim {dim} (> dense_fallback_dim "
                f"{dense_fallback_dim})")
    k = min(num_states, res.m)
    vecs = ritz_vectors(res, evecs[:, :k])
    del res             # the refinement below needs the basis's memory
    # normalize (Ritz vectors are orthonormal up to reorth tolerance)
    norms = jnp.linalg.norm(vecs, axis=1, keepdims=True)
    vecs = vecs / norms
    evals = evals[:k]
    jax.block_until_ready(vecs)
    t0 = time.perf_counter()
    if refine:
        evals = _maybe_refine(ham, evals, vecs)
    return ret(evals, vecs,
               SolveInfo(converged, resid / scale, steps,
                         refine_seconds=time.perf_counter() - t0))
