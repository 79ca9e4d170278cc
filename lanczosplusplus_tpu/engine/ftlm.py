"""Finite-temperature Lanczos method (FTLM).

Capability beyond the reference: the reference's thermal pipeline
(src/ed.cpp:22-59 + src/Engine/ExactDiag.h:26-92; src/thermal.cpp)
needs the FULL spectrum of every sector (dense LAPACK, O(dim^3)), so it
is limited to tiny Hilbert spaces.  FTLM (Jaklic & Prelovsek, PRB 49,
5065 (1994)) estimates canonical traces with R random vectors and M
Lanczos steps each:

    Tr[e^{-bH} A] ~= (dim/R) sum_r sum_j e^{-b eps_j^r}
                     <r|psi_j^r><psi_j^r|A|r>

With |v_0> = |r>, <r|psi_j> is just u_j[0] of the tridiagonal
eigenvector, and <psi_j|A|r> = sum_i u_j[i] <v_i|A|r>, so the whole
estimator needs only (a) the per-vector tridiagonals and (b) the dot of
every Krylov vector against the precomputed y_r = A|r> — both available
from the memory-light three-term recurrence with O(2 vectors) storage.
No Krylov basis is ever materialized.

Device shape: the R random vectors run as ONE batched recurrence —
each Lanczos step is a single batched SpMM (`Hamiltonian.matmat`,
dense Kronecker factors as GEMMs) over the (dim, R) block, plus
per-column axpy/dots.  Everything is one `lax.scan` with
static shapes; the tiny (M, R) tridiagonals are eigensolved on host.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from lanczosplusplus_tpu.solver.lanczos import tridiag_eigh
from lanczosplusplus_tpu.config import matmul_precision


@partial(jax.jit, static_argnums=(3,))
def _ftlm_recurrence(ham, V0, Yops, steps):
    """Batched plain Lanczos over the ROWS of V0 (R, dim) — the
    batch-major layout keeps the factor contractions of the batched
    SpMM (`Hamiltonian.matmat_t`) as clean GEMMs without transposes.

    Returns per-step (alphas, betas) of shape (M, R) and the Krylov
    dots D[m, o, r] = <v_m | Yops[o, r, :]> needed for operator
    estimators.  Yops may be (0, R, dim) when only H-moments are
    wanted."""
    rdt = jnp.float64 if V0.dtype in (jnp.float64, jnp.complex128) \
        else jnp.float32

    from lanczosplusplus_tpu.core.sparse import apply_block_t

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
        dots = jnp.einsum("rd,ord->or", jnp.conj(V), Yops,
                          precision=matmul_precision())
        return (V_next, V, beta), (alpha, beta, dots)

    init = (V0, jnp.zeros_like(V0), jnp.zeros((V0.shape[0],), rdt))
    _, (alphas, betas, dots) = jax.lax.scan(body, init, None,
                                            length=steps)
    return alphas, betas, dots


@dataclasses.dataclass
class FTLMResult:
    betas: np.ndarray                 # (T,) inverse temperatures
    energy: np.ndarray                # (T,) <H>
    energy2: np.ndarray               # (T,) <H^2>
    specific_heat: np.ndarray         # (T,) beta^2 (<H^2>-<H>^2)
    log_z: np.ndarray                 # (T,) ln Z (absolute, incl. dim/R)
    observables: Dict[str, np.ndarray]  # name -> (T,) <A>
    e0_estimate: float                # lowest Ritz value seen
    num_vectors: int
    steps: int

    @property
    def free_energy(self) -> np.ndarray:
        """F(T) = -ln Z / beta."""
        return -self.log_z / self.betas

    @property
    def entropy(self) -> np.ndarray:
        """S(T) = beta (<H> - F)  (k_B = 1)."""
        return self.betas * self.energy + self.log_z


def ftlm(ham, beta_grid, num_vectors: int = 32, steps: int = 80,
         operators: Optional[Dict[str, object]] = None,
         seed: int = 982451653,
         start_vectors=None, trace_dim: Optional[int] = None) -> FTLMResult:
    """FTLM thermal averages of H, H^2 and optional static operators.

    `operators` maps a name to either a 1-D diagonal array (dim,) or an
    object with `.matmat(x)` acting within the same sector (e.g. a
    `Hamiltonian` built from an operator's index map).  Operators that
    change the (nup, ndown) sector are out of scope here, matching the
    reference's thermal pipeline which also rotates sector-preserving
    matrices only (src/thermal.cpp:94-232).
    """
    operators = operators or {}
    if hasattr(ham, "inner") and hasattr(ham, "perm") and all(
            not (hasattr(op, "matmat") or hasattr(op, "matmat_t"))
            for op in operators.values()):
        # PermutedHamiltonian: traces are basis-independent and the
        # flat wrap would add a whole-dim perm gather per step — run
        # in the inner (block) layout, permuting any
        # diagonal operators (sign^2 = 1 cancels in the sandwich).
        # Caller-provided start vectors are in flat order: convert.
        perm = np.asarray(ham.perm)
        sgn = None if ham.sign is None else np.asarray(ham.sign)
        operators = {k: np.asarray(op)[perm]
                     for k, op in operators.items()}
        if start_vectors is not None:
            sv = np.asarray(start_vectors)[perm, :]
            if sgn is not None:
                sv = sv * sgn[:, None]
            start_vectors = sv
        ham = ham.inner

    dim = ham.dim
    dtype = ham.dtype
    steps = int(min(steps, dim))
    beta_grid = np.asarray(beta_grid, dtype=np.float64)

    if start_vectors is not None:
        # caller-provided start block (columns need not be random: a
        # complete orthonormal set makes the trace estimator exact —
        # used by the correctness tests)
        V0 = jnp.asarray(start_vectors, dtype=dtype)
    else:
        from lanczosplusplus_tpu.solver.lanczos import random_start_block
        V0 = random_start_block(dim, num_vectors, seed, dtype)
    num_vectors = int(V0.shape[1])

    names = list(operators.keys())
    yops = []
    for name in names:
        op = operators[name]
        if hasattr(op, "matmat"):
            yops.append(jnp.asarray(op.matmat(V0)))
        elif hasattr(op, "matmat_t"):
            yops.append(jnp.asarray(op.matmat_t(V0.T)).T)
        else:
            diag = jnp.asarray(op, dtype=dtype)
            if diag.ndim != 1 or diag.shape[0] != dim:
                raise ValueError(f"operator {name!r}: expected (dim,) "
                                 "diagonal or .matmat object")
            yops.append(diag[:, None] * V0)
    # batch-major (R, dim) layout for the recurrence
    Yops = jnp.stack([y.T for y in yops]) if yops else \
        jnp.zeros((0, num_vectors, dim), dtype)

    alphas, betas_l, dots = _ftlm_recurrence(ham, V0.T, Yops, steps)
    alphas = np.asarray(alphas, dtype=np.float64)      # (M, R)
    betas_l = np.asarray(betas_l, dtype=np.float64)    # (M, R)
    dots = np.asarray(dots)                            # (M, O, R)

    # host: per-vector tridiagonal eigensolve + Boltzmann accumulation
    T = beta_grid.shape[0]
    nops = len(names)
    num_e = np.zeros(T)
    num_e2 = np.zeros(T)
    num_ops = np.zeros((nops, T))
    zsum = np.zeros(T)
    e0 = np.inf
    scale = max(np.abs(alphas).max(initial=0.0),
                np.abs(betas_l).max(initial=0.0), 1.0)
    ritz = []
    for r in range(num_vectors):
        m = steps
        for j in range(steps - 1):
            if betas_l[j, r] <= 1e-12 * scale:
                m = j + 1
                break
        evals, evecs = tridiag_eigh(alphas[:m, r], betas_l[:m, r])
        ritz.append((evals, evecs[0, :].copy(),
                     evecs.T @ dots[:m, :, r] if nops else None))
        e0 = min(e0, evals[0])
    for evals, u0, projected in ritz:
        for t, b in enumerate(beta_grid):
            w = np.exp(-b * (evals - e0))
            zsum[t] += float((u0 * u0 * w).sum())
            num_e[t] += float((u0 * u0 * w * evals).sum())
            num_e2[t] += float((u0 * u0 * w * evals ** 2).sum())
            for o in range(nops):
                # <r|psi_j><psi_j|A|r> = u0_j * (U^T D)_j,o  (real tridiag)
                num_ops[o, t] += float(
                    np.real(u0 * projected[:, o]) @ w)
    energy = num_e / zsum
    energy2 = num_e2 / zsum
    cv = beta_grid ** 2 * (energy2 - energy ** 2)
    # trace_dim: the true Hilbert dimension when ham is padded for a
    # device mesh (padded rows are excluded by zeroed start vectors
    # but must not inflate the trace normalization)
    log_z = (np.log(zsum) + np.log((trace_dim or dim) / num_vectors)
             - beta_grid * e0)
    obs = {names[o]: num_ops[o] / zsum for o in range(nops)}
    return FTLMResult(betas=beta_grid, energy=energy, energy2=energy2,
                      specific_heat=cv, log_z=log_z, observables=obs,
                      e0_estimate=float(e0), num_vectors=num_vectors,
                      steps=steps)


def ltlm(ham, beta_grid, operators: Dict[str, object],
         num_vectors: int = 16, steps: int = 80,
         seed: int = 982451653, start_vectors=None,
         trace_dim: Optional[int] = None):
    """Low-temperature Lanczos method (Aichhorn, Daghofer, Evertz &
    von der Linden, PRB 67, 161103(R) (2003)): the SYMMETRIC estimator

        <A>(b) ~= sum_r sum_{j,l} e^{-b(eps_j+eps_l)/2}
                  <r|psi_j><psi_j|A|psi_l><psi_l|r>  /  Z

    Unlike the plain FTLM observable estimator (whose numerator and
    denominator decorrelate as T -> 0, leaving O(1/sqrt(R)) noise at
    low temperature), the symmetric form converges to <gs|A|gs>
    exactly as beta -> inf for every start vector.  Costs a stored-V
    Lanczos run per vector plus one (M, dim)x(dim, M) GEMM per
    operator (a GEMM).  Operators: (dim,) diagonal arrays or objects with
    matmat/matmat_t, sector-preserving.  `trace_dim` is the true
    Hilbert dimension when ham is padded for a device mesh (same
    convention as `ftlm`).  Returns {name: (T,) array}, plus '_log_z'
    for the partition estimate."""
    from lanczosplusplus_tpu.solver.lanczos import (
        random_start_block, tridiagonalize, tridiag_eigh)

    dim = ham.dim
    dtype = ham.dtype
    steps = int(min(steps, dim))
    beta_grid = np.asarray(beta_grid, dtype=np.float64)
    if start_vectors is not None:
        V0 = jnp.asarray(start_vectors, dtype=dtype)
    else:
        V0 = random_start_block(dim, num_vectors, seed, dtype)
    num_vectors = int(V0.shape[1])
    names = list(operators.keys())

    per_run = []
    e0 = np.inf
    for r in range(num_vectors):
        res = tridiagonalize(ham, V0[:, r], steps)
        evals, evecs = tridiag_eigh(res.alphas, res.betas)
        e0 = min(e0, float(evals[0]))
        Vm = res.V[:res.m]                      # (m, dim)
        ritz = {}
        for name in names:
            op = operators[name]
            if hasattr(op, "matmat"):
                Y = jnp.asarray(op.matmat(Vm.T))           # (dim, m)
            elif hasattr(op, "matmat_t"):
                Y = jnp.asarray(op.matmat_t(Vm)).T
            else:
                diag = jnp.asarray(op, dtype=dtype)
                Y = (diag[:, None] * Vm.T)
            G = np.asarray(jnp.matmul(jnp.conj(Vm), Y,
                                       precision=matmul_precision()))
            ritz[name] = evecs.T @ G @ evecs
        per_run.append((evals, evecs[0].copy(), ritz))
    T = beta_grid.shape[0]
    out = {name: np.zeros(T) for name in names}
    zs = np.zeros(T)
    for evals, u0, ritz in per_run:
        for t, b in enumerate(beta_grid):
            half = np.exp(-0.5 * b * (evals - e0)) * u0
            zs[t] += float((np.exp(-b * (evals - e0)) * u0 * u0).sum())
            for name in names:
                out[name][t] += float(half @ np.real(ritz[name]) @ half)
    for name in names:
        out[name] = out[name] / zs
    out["_log_z"] = (np.log(zs)
                     + np.log((trace_dim or dim) / num_vectors)
                     - beta_grid * e0)
    return out


def _schedule_grid(inp):
    """(tbs, beta_grid) from the reference's TemperatureOrBeta* labels
    (ExactDiag.h:31-39)."""
    what = inp.string("TemperatureOrBeta", default="temperature")
    if what not in ("temperature", "beta"):
        raise ValueError("TemperatureOrBeta= must be beta or temperature")
    start = inp.real("TemperatureOrBetaStart", default=0.0)
    total = inp.integer("TemperatureOrBetaTotal", default=0)
    step = inp.real("TemperatureOrBetaStep", default=0.0)
    tbs = [start + i * step for i in range(total)]
    tiny = 1e-12
    if what == "beta":
        beta_grid = np.asarray(tbs, dtype=np.float64)
    else:
        beta_grid = np.asarray(
            [1.0 / t if abs(t) > tiny else 1.0 / tiny for t in tbs])
    return tbs, beta_grid


def _schedule_ham(model, inp):
    """Sector Hamiltonian for the thermal schedule drivers: the
    factored form under SolverOptions=factored, else the flat path."""
    basis = model.create_basis(model.default_parts(inp))
    dtype = np.complex128 if "useComplex" in inp.solver_options() \
        else np.float64
    ham = None
    if "factored" in inp.solver_options():
        from lanczosplusplus_tpu.models import \
            factored_hamiltonian_or_none
        ham = factored_hamiltonian_or_none(
            model, basis, model.default_parts(inp), dtype)
    if ham is None:
        ham = model.hamiltonian(basis, dtype=dtype)
    return ham


def ftlm_schedule(model, inp, num_vectors: int = 32, steps: int = 80,
                  seed: int = 982451653):
    """<E>(T or beta) on the reference's TemperatureOrBeta* schedule
    (ExactDiag.h:31-39 labels) estimated by FTLM instead of the full
    spectrum — the `ed` capability at Hilbert dimensions where dense
    diagonalization is impossible."""
    tbs, beta_grid = _schedule_grid(inp)
    ham = _schedule_ham(model, inp)
    res = ftlm(ham, beta_grid, num_vectors=num_vectors, steps=steps,
               seed=seed)
    return [(tb, float(e)) for tb, e in zip(tbs, res.energy)], res


def ltlm_schedule(model, inp, num_vectors: int = 16, steps: int = 80,
                  seed: int = 982451653):
    """<E>(T or beta) on the same schedule via the LTLM symmetric
    estimator (A = H): noise-free in the beta -> inf limit where the
    plain FTLM energy estimator decorrelates, so the low-temperature
    tail of the `ed` curve is exact instead of O(1/sqrt(R))-noisy.
    Costs one stored-V Lanczos run per random vector plus one
    (M, dim)x(dim, M) GEMM (the H projection)."""
    tbs, beta_grid = _schedule_grid(inp)
    ham = _schedule_ham(model, inp)
    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # traces are basis-independent: run the recurrence and the H
        # projection in the block layout, without the
        # PermutedHamiltonian wrap's whole-dim perm gather per matvec
        # (mirrors ftlm() / GrandCanonicalFTLM)
        ham = ham.inner
    res = ltlm(ham, beta_grid, {"energy": ham},
               num_vectors=num_vectors, steps=steps, seed=seed)
    return [(tb, float(e)) for tb, e in zip(tbs, res["energy"])], res
