"""Kernel polynomial method (KPM) spectral densities.

Capability beyond the reference: the reference computes dynamic
correlations only as Lanczos continued fractions (Engine.h:460-490).
KPM (Weisse, Wellein, Alvermann & Fehske, RMP 78, 275 (2006)) expands

    A_phi(omega) = <phi| delta(omega - (H - E0)) |phi>

in Chebyshev polynomials of the rescaled Hamiltonian.  The recurrence
|t_{k+1}> = 2 Ht |t_k> - |t_{k-1}> is pure SpMV with O(2 vectors)
memory and NO reorthogonalization — every step is the same
static-shape fused kernel, and the product-rule doubling
(mu_{2k} = 2<t_k|t_k> - mu_0, mu_{2k+1} = 2<t_{k+1}|t_k> - mu_1)
halves the matvec count.  Jackson damping turns the truncated series
into a strictly positive, resolution-controlled density — no ghost
poles, unlike plain-Lanczos continued fractions at large depth.

Total densities of states use the stochastic trace over a batch of
random vectors: the recurrence then runs on a (dim, R) block so each
step is one batched SpMM (`Hamiltonian.matmat`) of GEMMs.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp


def spectral_bounds(ham, steps: int = 64, seed: int = 271828,
                    margin: float = 0.05):
    """(emin, emax) safely enclosing spec(H): extremal Ritz values of a
    short plain Lanczos run, padded by `margin` of the spread."""
    from lanczosplusplus_tpu.solver.lanczos import (
        random_start_vector, tridiagonalize_plain, tridiag_eigh)
    steps = int(min(steps, ham.dim))
    v0 = random_start_vector(ham.dim, seed, ham.dtype)
    res = tridiagonalize_plain(ham, v0, steps)
    evals, _ = tridiag_eigh(res.alphas, res.betas)
    lo, hi = float(evals[0]), float(evals[-1])
    pad = margin * max(hi - lo, 1.0)
    return lo - pad, hi + pad


def jackson_kernel(n: int) -> np.ndarray:
    """Jackson damping g_k, the optimal positive kernel (RMP 78, 275,
    eq. 71): resolution ~ pi/n in the rescaled variable."""
    k = np.arange(n)
    q = np.pi / (n + 1)
    return ((n - k + 1) * np.cos(q * k) +
            np.sin(q * k) / np.tan(q)) / (n + 1)


@partial(jax.jit, static_argnums=(4,))
def _moment_recurrence(ham, phi0, a, b, num_pairs):
    """Chebyshev moments of the batch-MAJOR block phi0 (R, dim) for
    the rescaled Ht = (H - b)/a.  Returns (mu_even, mu_odd) of shape
    (num_pairs, R): mu_even[k] = mu_{2k}, mu_odd[k] = mu_{2k+1},
    via the product-rule doubling (one matvec per moment PAIR).  The
    row layout keeps the batched SpMM (`Hamiltonian.matmat_t`) on
    clean GEMMs."""
    from lanczosplusplus_tpu.core.sparse import apply_block_t

    ainv = jnp.asarray(1.0, phi0.dtype) / a.astype(phi0.dtype)
    bshift = b.astype(phi0.dtype)

    def ht(x):
        return (apply_block_t(ham, x) - bshift * x) * ainv

    t0 = phi0                      # T_0 |phi>
    t1 = ht(phi0)                  # T_1 |phi>
    mu0 = jnp.real(jnp.sum(jnp.conj(phi0) * phi0, axis=1))
    mu1 = jnp.real(jnp.sum(jnp.conj(phi0) * t1, axis=1))

    def body(carry, _):
        tk, tk1 = carry            # T_k, T_{k+1} applied to phi
        even = 2.0 * jnp.real(jnp.sum(jnp.conj(tk) * tk, axis=1)) - mu0
        odd = 2.0 * jnp.real(jnp.sum(jnp.conj(tk1) * tk, axis=1)) - mu1
        tk2 = 2.0 * ht(tk1) - tk
        return (tk1, tk2), (even, odd)

    _, (mu_even, mu_odd) = jax.lax.scan(body, (t0, t1), None,
                                        length=num_pairs)
    return mu_even, mu_odd


@dataclasses.dataclass
class KPMResult:
    moments: np.ndarray     # (N,) kernel-free Chebyshev moments (summed over R)
    a: float                # scale: H = a*Ht + b
    b: float
    num_moments: int

    def density(self, energies, kernel: Optional[np.ndarray] = None):
        """rho(E) = [g_0 mu_0 + 2 sum_{k>=1} g_k mu_k T_k(x)]
        / (pi sqrt(1-x^2) a) with x = (E-b)/a, normalized so that
        integral dE rho(E) = mu_0."""
        g = jackson_kernel(self.num_moments) if kernel is None else kernel
        x = (np.asarray(energies, dtype=np.float64) - self.b) / self.a
        inside = np.abs(x) < 1.0            # zero outside spec(Ht)
        x = np.clip(x, -1.0 + 1e-12, 1.0 - 1e-12)
        theta = np.arccos(x)
        acc = g[0] * self.moments[0] * np.ones_like(x)
        for k in range(1, self.num_moments):
            acc = acc + 2.0 * g[k] * self.moments[k] * np.cos(k * theta)
        return np.where(inside,
                        acc / (np.pi * np.sqrt(1.0 - x * x) * self.a),
                        0.0)


def chebyshev_moments(ham, phi, num_moments: int,
                      bounds=None) -> KPMResult:
    """Kernel-free moments mu_k = <phi|T_k(Ht)|phi>, k < num_moments.

    phi may be (dim,) or (dim, R); moments are summed over the block
    columns (the stochastic-trace / multi-operator accumulation)."""
    if bounds is None:
        bounds = spectral_bounds(ham)
    emin, emax = bounds
    a = 0.5 * (emax - emin)
    b = 0.5 * (emax + emin)
    phi2 = jnp.asarray(phi)
    if phi2.ndim == 1:
        phi2 = phi2[None, :]
    else:
        phi2 = phi2.T                      # batch-major (R, dim)
    num_pairs = (num_moments + 1) // 2
    mu_even, mu_odd = _moment_recurrence(
        ham, phi2, jnp.asarray(a, jnp.float64).astype(phi2.dtype),
        jnp.asarray(b, jnp.float64).astype(phi2.dtype), num_pairs)
    mu_even = np.asarray(mu_even, dtype=np.float64).sum(axis=1)
    mu_odd = np.asarray(mu_odd, dtype=np.float64).sum(axis=1)
    mu = np.empty(2 * num_pairs)
    mu[0::2] = mu_even
    mu[1::2] = mu_odd
    # |T_k| <= 1 on [-1, 1], so |mu_k| <= mu_0 whenever the bounds
    # enclose the spectrum; outside, T_k grows like cosh(k acosh|x|)
    # and the density is silently garbage — fail loudly instead.
    if not np.isfinite(mu).all() or \
            np.abs(mu).max() > 2.0 * abs(mu[0]) + 1e-9:
        raise ValueError(
            "Chebyshev moments exceed the |T_k|<=1 bound: the spectral "
            "bounds do not enclose spec(H) — widen `bounds` or raise "
            "the spectral_bounds margin/steps")
    return KPMResult(moments=mu[:num_moments], a=a, b=b,
                     num_moments=num_moments)


def kpm_dos(ham, num_moments: int = 256, num_vectors: int = 16,
            seed: int = 314159, bounds=None) -> KPMResult:
    """Total density of states Tr[delta(E - H)] by stochastic trace:
    moments averaged over R random vectors, scaled by dim."""
    from lanczosplusplus_tpu.solver.lanczos import random_start_block

    if hasattr(ham, "inner") and hasattr(ham, "perm"):
        # trace is basis-independent: skip the flat wrap's per-step
        # whole-dim perm gather
        ham = ham.inner
    V0 = random_start_block(ham.dim, num_vectors, seed, ham.dtype)
    res = chebyshev_moments(ham, V0, num_moments, bounds=bounds)
    res.moments *= ham.dim / num_vectors
    return res


def kpm_spectral(ham_dst, phi, omegas, e0: float,
                 num_moments: int = 512, bounds=None,
                 weight: Optional[float] = None):
    """A(omega) = <phi| delta(omega - (H_dst - e0)) |phi> on the omega
    grid — the KPM counterpart of the continued-fraction
    `calc_spectral` (Engine.h:460-490): phi = op|gs> lives in the
    destination sector, omega is measured from the ground-state energy
    e0 of the source sector."""
    res = chebyshev_moments(ham_dst, phi, num_moments, bounds=bounds)
    if weight is not None and res.moments[0] > 0:
        res.moments = res.moments * (weight / res.moments[0])
    return res.density(np.asarray(omegas, dtype=np.float64) + e0)
