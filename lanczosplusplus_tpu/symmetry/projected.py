"""Momentum-projected Lanczos: translation symmetry without blocks.

The orbit-block machinery (symmetry/blocks.py) assembles each k-block
as a generic ELL with random-column gathers.  The alternative
implemented here (SolverOptions=projected) never assembles blocks at
all: Lanczos runs in the FULL space on the fast factored matvec,
restricted to momentum sector k by composing every matvec with the
projector

    P_k = (c_k / L) sum_g  cos(2 pi k g / L) T^g        (real form)

Since [H, T] = 0, H_k := P_k H equals P_k H P_k and is symmetric; its
spectrum on the sector is exactly the k-block's (for 0 < k < L/2 the
real projector spans the degenerate (k, -k) pair — their spectra are
equal for a real H).  Applying P_k every step also kills the f32
round-off leakage into other sectors that a start-projected-only run
would accumulate.

The enabling fact: for bases where state index == bit word and
translation is a cyclic BIT rotation (the Kitaev chain's identity
basis, BasisKitaev.h:28-34), T^g is a pure reshape-transpose:

    (T^g v) = v.reshape(2^g, 2^(L-g)).T.reshape(-1)

— no gathers — so P_k costs about one extra matvec.  Reference capability: TranslationSymmetry.h:251-268
(block split); this module is the deviation that makes it run at
accelerator speed (recorded in docs/PARITY.md).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp


def rotation_weights(nsite: int, k: int) -> np.ndarray:
    """Real momentum-projector weights over the translation group: the
    rank-preserving combination of e^{+ik} and e^{-ik} characters (a
    projector: P^2 = P), so all sectors 0..L//2 cover the space."""
    g = np.arange(nsite)
    scale = 1.0 / nsite if k in (0, nsite - k) else 2.0 / nsite
    return (scale * np.cos(2.0 * np.pi * k * g / nsite))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RotationProjectedHamiltonian:
    """H restricted to momentum sector k of a cyclic bit-rotation
    translation group: matvec(x) = P_k (H x) with P_k applied as
    weighted reshape-transposes."""
    inner: Any                       # the full-space Hamiltonian pytree
    weights: jax.Array               # (L,) real projector weights
    nbits: int = dataclasses.field(metadata=dict(static=True))

    @property
    def dim(self):
        return self.inner.dim

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def quantized(self):
        return getattr(self.inner, "quantized", False)

    def project(self, v):
        acc = self.weights[0].astype(v.dtype) * v
        for g in range(1, self.weights.shape[0]):
            tg = v.reshape(1 << g, -1).T.reshape(-1)
            acc = acc + self.weights[g].astype(v.dtype) * tg
        return acc

    def matvec(self, x):
        return self.project(self.inner.matvec(x))


def translation_sectors(nsite: int):
    """The k values whose real projectors partition the space."""
    return list(range(nsite // 2 + 1))


class ProjectedTranslationSolver:
    """Per-momentum ground states of a translation-invariant H whose
    basis index is the bit word (Kitaev chain: full 2^L space).

    Duck-typed like the block symmetries where it matters to Engine
    (`sectors()`, `transform()`), but solving happens in the full
    space: `solve_sector(k, ...)` returns (evals, vecs, info) with the
    vectors already in the site basis.  `purity(k, v)` = ||P_k v||^2 /
    ||v||^2 — 1.0 for a clean sector vector (the honesty probe for the
    projected run)."""

    def __init__(self, ham, nsite: int):
        if ham.dim != (1 << nsite):
            raise ValueError(
                f"projected translation needs the full 2^L space "
                f"(dim {ham.dim} != 2^{nsite})")
        self.ham = ham
        self.nsite = nsite
        self._ks = translation_sectors(nsite)

    def sectors(self) -> int:
        return len(self._ks)

    def momentum(self, s: int) -> int:
        return self._ks[s]

    def projected(self, s: int) -> RotationProjectedHamiltonian:
        w = rotation_weights(self.nsite, self._ks[s])
        return RotationProjectedHamiltonian(
            inner=self.ham, weights=jnp.asarray(
                w.astype(np.float32 if jnp.dtype(self.ham.dtype) in
                         (jnp.float32, jnp.complex64) else np.float64)),
            nbits=self.nsite)

    def start_vector(self, s: int, seed: int = 7239443):
        from lanczosplusplus_tpu.solver.lanczos import \
            random_start_vector
        pk = self.projected(s)
        v = pk.project(random_start_vector(self.ham.dim, seed,
                                           self.ham.dtype))
        n = jnp.linalg.norm(v)
        if float(n) == 0.0:
            raise ValueError(f"momentum sector {self._ks[s]} start "
                             "vector vanished")
        return v / n

    def solve_sector(self, s: int, num_states: int = 1,
                     max_steps: int = 200, seed: int = 7239443,
                     **kw):
        """(evals, vecs, info) for momentum sector s; refinement is
        evaluated against the UNPROJECTED H (the eigenvector lies in
        the sector, so the Rayleigh quotients agree — but the inner
        form has the exact host-f64 refinement route)."""
        from lanczosplusplus_tpu.solver import lanczos as lz
        pk = self.projected(s)
        v0 = self.start_vector(s, seed)
        evals, vecs, info = lz.lowest_states(
            pk, num_states=num_states, max_steps=max_steps,
            v0=v0, refine=False, return_info=True,
            dense_fallback_dim=0, **kw)
        evals = lz._maybe_refine(self.ham, evals, vecs)
        return evals, vecs, info

    def purity(self, s: int, v) -> float:
        pk = self.projected(s)
        v = jnp.asarray(v)
        pv = pk.project(v)
        return float(jnp.real(jnp.vdot(v, pv))
                     / jnp.real(jnp.vdot(v, v)))

    def transform(self, vec, sector):
        return np.asarray(vec)
