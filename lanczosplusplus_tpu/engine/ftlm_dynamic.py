"""Finite-temperature dynamic correlations by the FTLM double-Krylov
estimator.

The reference computes finite-T Lehmann weights of <A(t) B> from FULL
spectra of every sector (src/thermal.cpp:94-232 + grandCanonical.pl) —
dense O(dim^3) per sector.  The FTLM estimator (Jaklic & Prelovsek,
Adv. Phys. 49, 1 (2000), eq. 2.15) replaces both full spectra with two
Lanczos runs per random vector:

    S_AB(w, b) = (1/Z) sum_n e^{-b E_n} <n|A^+ delta(w - H + E_n) B|n>
       ~= (dim/(R Zt)) sum_r sum_{j,l} e^{-b eps_j}
          <r|psi_j><psi_j|A^+|phi_l><phi_l|B|r> delta(w - et_l + eps_j)

with |psi_j> the Ritz vectors of the run from |r> (source sector) and
|phi_l> those of the run from B|r> (destination sector).  The cross
matrix <psi_j|A^+|phi_l> is one (M, dim)x(dim, M') GEMM through the
operator-applied Krylov block and everything else is the
tiny tridiagonal eigendata.

Exactness property used by the tests: with a complete orthonormal start
set and full Krylov depth the estimator equals the exact double Lehmann
sum (same argument as the static FTLM trace).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from lanczosplusplus_tpu.solver import lanczos as lz


@dataclasses.dataclass
class FTLMDynamicRun:
    evals1: np.ndarray   # (m1,) source Ritz values
    u0: np.ndarray       # (m1,) <r|psi_j>
    coupling: np.ndarray  # (m1, m2) <psi_j|A^+|phi_l>
    evals2: np.ndarray   # (m2,) destination Ritz values
    w0: np.ndarray       # (m2,) <phi_l|B|r>


@dataclasses.dataclass
class FTLMDynamic:
    runs: List[FTLMDynamicRun]
    e0: float            # min source Ritz value (Boltzmann shift)
    dim: int
    num_vectors: int

    def poles(self, beta: float):
        """(omega_p, weight_p) at inverse temperature beta, normalized
        by the same-estimator partition function Zt."""
        oms, wts = [], []
        z = 0.0
        for run in self.runs:
            bw = np.exp(-beta * (run.evals1 - self.e0))
            z += float((bw * np.abs(run.u0) ** 2).sum())
            w = (bw * run.u0)[:, None] * np.real(
                run.coupling * run.w0[None, :])
            oms.append((run.evals2[None, :] -
                        run.evals1[:, None]).ravel())
            wts.append(w.ravel())
        z = z if z > 0 else 1.0
        return np.concatenate(oms), np.concatenate(wts) / z

    def evaluate(self, beta: float, omegas, delta: float):
        """Lorentzian-broadened S(omega) on a grid (the lorentzian
        driver's convention, reference: src/lorentzian.cpp:86-125)."""
        om, wt = self.poles(beta)
        omegas = np.asarray(omegas, dtype=np.float64)
        return (wt[None, :] * (delta / np.pi) /
                ((omegas[:, None] - om[None, :]) ** 2 + delta ** 2)
                ).sum(axis=1)


def ftlm_source_runs(ham_src, V0, steps: int):
    """Per-column stored-V tridiagonalizations of the source sector —
    the dominant cost of ftlm_dynamic, factored out so callers
    assembling several operator types (e.g. addition + removal) pay it
    once."""
    runs = []
    for r in range(V0.shape[1]):
        res1 = lz.tridiagonalize(ham_src, jnp.asarray(V0[:, r]), steps)
        evals1, evecs1 = lz.tridiag_eigh(res1.alphas, res1.betas)
        runs.append((res1, evals1, evecs1))
    return runs


def ftlm_dynamic(ham_src, ham_dst, apply_b, num_vectors: int = 16,
                 steps: int = 100, seed: int = 152917,
                 apply_a=None, start_vectors=None,
                 source_runs=None) -> FTLMDynamic:
    """Build the FTLM double-Krylov pole data for S_AB(omega, beta).

    apply_b: maps a (dim_src,) numpy vector to B|v> in the destination
    sector (dim_dst,).  apply_a defaults to apply_b (the diagonal
    A = B spectral function).  start_vectors overrides the random
    block (columns; a complete orthonormal set + steps=dim makes the
    estimator exact).  source_runs: precomputed ftlm_source_runs for
    the SAME start block, shared across operator types."""
    apply_a = apply_a or apply_b
    dim = ham_src.dim
    steps = int(min(steps, dim))
    dtype = ham_src.dtype
    if start_vectors is not None:
        V0 = np.asarray(start_vectors)
    else:
        V0 = np.asarray(lz.random_start_block(dim, num_vectors, seed,
                                              dtype))
    num_vectors = V0.shape[1]
    steps_dst = int(min(steps, ham_dst.dim))
    if source_runs is None:
        source_runs = ftlm_source_runs(ham_src, V0, steps)

    runs = []
    e0 = np.inf
    for r in range(num_vectors):
        res1, evals1, evecs1 = source_runs[r]
        e0 = min(e0, float(evals1[0]))
        y = apply_b(V0[:, r])
        ynorm = float(np.linalg.norm(y))
        if ynorm < 1e-14:
            # B|r> = 0: no poles, but the run still contributes to the
            # partition-function normalization (dropping it would
            # overcount S by 1/fraction-annihilated)
            runs.append(FTLMDynamicRun(
                evals1=evals1, u0=evecs1[0].copy(),
                coupling=np.zeros((len(evals1), 0)),
                evals2=np.zeros(0), w0=np.zeros(0)))
            continue
        res2 = lz.tridiagonalize(ham_dst, jnp.asarray(y / ynorm),
                                 steps_dst)
        evals2, evecs2 = lz.tridiag_eigh(res2.alphas, res2.betas)
        # cross coupling <psi_j|A^+|phi_l> = (A V1^T u_j)^+ (V2^T w_l)
        V1 = np.asarray(res1.V[:res1.m])
        V2 = np.asarray(res2.V[:res2.m])
        AV1 = np.stack([np.asarray(apply_a(V1[i]))
                        for i in range(res1.m)])         # (m1, dim_dst)
        G = np.conj(AV1) @ V2.T                          # (m1, m2)
        C = evecs1.T @ G @ evecs2
        runs.append(FTLMDynamicRun(
            evals1=evals1, u0=evecs1[0].copy(), coupling=C,
            evals2=evals2, w0=ynorm * evecs2[0].copy()))
    return FTLMDynamic(runs=runs, e0=float(e0), dim=dim,
                       num_vectors=num_vectors)
