"""Finite-temperature engines.

Two capabilities from the reference:

1. `ExactDiag` — full diagonalization of one sector + <E>(T or beta)
   schedule (reference: src/ed.cpp:22-59, src/Engine/ExactDiag.h:26-92;
   labels TemperatureOrBeta=, TemperatureOrBetaStart/Total/Step=).
2. `GrandCanonical` — the thermal post-processing pipeline: full
   spectra of every (nup, ndown) sector, grand-canonical Z / density /
   energy at (beta, mu), and Lehmann pole weights of
   <A(t) B> correlators (reference: src/thermal.cpp:94-232 +
   scripts/grandCanonical.pl sector sweep; operator matrices as printed
   by printOperators, src/Models/HubbardOneOrbital/HubbardOneOrbital.h:126-210).

The reference splits this across dumpmatrix runs, a Perl driver and a
separate binary; here it is one in-process pipeline with device `eigh`
per sector and matmuls for the operator rotations.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from lanczosplusplus_tpu.engine.operators import LabeledOperator


@dataclasses.dataclass
class SectorSpectrum:
    parts: tuple
    evals: np.ndarray     # (n,)
    evecs: np.ndarray     # (n, n) columns are eigenvectors
    nelectrons: int


def full_spectrum(model, basis, dtype=np.float64,
                  nelectrons=None) -> SectorSpectrum:
    ham = model.hamiltonian(basis, dtype=dtype)
    dense = jnp.asarray(ham.to_dense())
    evals, evecs = jnp.linalg.eigh(dense)
    parts = basis.parts
    if nelectrons is None:
        nelectrons = sum(p for p in parts
                         if isinstance(p, (int, np.integer)))
    return SectorSpectrum(parts=parts, evals=np.asarray(evals),
                          evecs=np.asarray(evecs),
                          nelectrons=int(nelectrons))


class ExactDiag:
    """reference: src/Engine/ExactDiag.h."""

    def __init__(self, model, inp):
        self.tb_what = inp.string("TemperatureOrBeta", default="temperature")
        if self.tb_what not in ("temperature", "beta"):
            raise ValueError("TemperatureOrBeta= must be beta or temperature")
        self.tb_start = inp.real("TemperatureOrBetaStart", default=0.0)
        self.tb_total = inp.integer("TemperatureOrBetaTotal", default=0)
        self.tb_step = inp.real("TemperatureOrBetaStep", default=0.0)
        basis = model.create_basis(model.default_parts(inp))
        self.spectrum = full_spectrum(model, basis)

    def energy_at(self, tb: float) -> float:
        e = self.spectrum.evals
        arg = -tb * e if self.tb_what == "beta" else -e / tb
        arg = arg - arg.max()  # stabilized; ratio is unchanged
        w = np.exp(arg)
        return float((e * w).sum() / w.sum())

    def schedule(self):
        return [(self.tb_start + i * self.tb_step,
                 self.energy_at(self.tb_start + i * self.tb_step))
                for i in range(self.tb_total)]

    def print_energies(self, os):
        os.write(f"#tb={self.tb_what}\n#Parameter Energy\n")
        for tb, e in self.schedule():
            os.write(f"{tb} {e}\n")


def operator_matrix(model, op_name, site, spin, orb, src_basis, dst_basis):
    """Dense (src, dst) operator matrix A[s, tgt(s)] = amp(s)
    (the reference's printOperatorC/setupOperator matrices,
    HubbardOneOrbital.h:161-210)."""
    op = LabeledOperator(op_name)
    tgt, amp, dst_dim = model.operator_map(op, site, spin, orb,
                                           src_basis, dst_basis)
    a = np.zeros((src_basis.size, dst_dim))
    mask = tgt >= 0
    a[np.nonzero(mask)[0], tgt[mask]] = amp[mask]
    return a


def _sector_parts_list(model, nsite: int, kind: str, nmax: int):
    """Sector lattice of the grand-canonical sweep.  The vacuum sector
    is included (the reference's grandCanonical.pl sweep omits it; its
    e^0 term belongs in Z); kind selects the sector lattice as
    grandCanonical.pl's canonical / tj / Heisenberg filters do
    (grandCanonical.pl:23-57)."""
    if kind == "heisenberg":
        twice_s = getattr(model, "twice_s", 1)
        return [(twice_s, szpc) for szpc in range(nsite * twice_s + 1)]
    return [(nup, ndown)
            for nup in range(nsite + 1)
            for ndown in range(nsite + 1)
            if nup + ndown <= nmax and
            not (kind == "tj" and nup + ndown > nsite)]


class GrandCanonical:
    """Full-spectra sweep over all (nup, ndown) sectors of a model
    (replaces scripts/grandCanonical.pl + src/thermal.cpp)."""

    def __init__(self, model, nsite: int, kind: str = "hubbard",
                 max_electrons: Optional[int] = None):
        self.model = model
        self.nsite = nsite
        self.sectors: List[SectorSpectrum] = []
        self._bases = {}
        nmax = max_electrons if max_electrons is not None else 2 * nsite
        for parts in _sector_parts_list(model, nsite, kind, nmax):
            try:
                basis = model.create_basis(parts)
            except Exception:
                continue
            if basis.size == 0:
                continue
            self._bases[parts] = basis
            # the chemical potential couples to the sector's conserved
            # number: electrons for fermion models, sum of site values
            # (szPlusConst) for Heisenberg
            ne = parts[1] if kind == "heisenberg" else sum(parts)
            self.sectors.append(full_spectrum(model, basis,
                                              nelectrons=ne))

    def _weights(self, beta, mu, constant=0.0):
        """Per-sector stabilized Boltzmann data."""
        out = []
        for s in self.sectors:
            factor = mu * s.nelectrons + constant
            out.append(beta * (factor - s.evals))
        shift = max(a.max() for a in out)
        return [np.exp(a - shift) for a in out], shift

    def partition(self, beta, mu, constant=0.0) -> float:
        ws, shift = self._weights(beta, mu, constant)
        return float(sum(w.sum() for w in ws) * np.exp(shift))

    def density(self, beta, mu, constant=0.0) -> float:
        ws, _ = self._weights(beta, mu, constant)
        z = sum(w.sum() for w in ws)
        num = sum(w.sum() * s.nelectrons
                  for w, s in zip(ws, self.sectors))
        return float(num / z)

    def energy(self, beta, mu, constant=0.0) -> float:
        ws, _ = self._weights(beta, mu, constant)
        z = sum(w.sum() for w in ws)
        num = sum((w * s.evals).sum() for w, s in zip(ws, self.sectors))
        return float(num / z)

    def correlation_poles(self, op_name, sites, spin, beta, mu,
                          constant=0.0):
        """Lehmann weights of <A^dag_site2(t) A_site1> at (beta, mu):
        list of (omega = e1 - e2 + mu, weight) (reference:
        thermal.cpp:125-190 computeThisSector)."""
        from lanczosplusplus_tpu.engine.operators import LabeledOperator as L

        op = L(op_name)
        ws, _ = self._weights(beta, mu, constant)
        z = sum(w.sum() for w in ws)
        poles = []
        total = 0.0
        for w, s in zip(ws, self.sectors):
            src_basis = self._bases[s.parts]
            new_parts = self.model.has_new_parts(s.parts, op, spin, 0)
            if new_parts is None:
                continue
            dst_basis = self._bases.get(new_parts)
            dst = next((t for t in self.sectors if t.parts == new_parts),
                       None)
            if dst is None or dst_basis is None:
                continue
            a = operator_matrix(self.model, op_name, sites[0], spin, 0,
                                src_basis, dst_basis)
            b = a if sites[1] == sites[0] else operator_matrix(
                self.model, op_name, sites[1], spin, 0, src_basis,
                dst_basis)
            # X_{n,n'} = U_src^dag A U_dst
            x = s.evecs.conj().T @ a @ dst.evecs
            y = s.evecs.conj().T @ b @ dst.evecs
            val = x * np.conj(y) * (w / z)[:, None]
            e1 = s.evals[:, None]
            e2 = dst.evals[None, :]
            omega = e1 - e2 + mu
            keep = np.abs(val) > 1e-12
            for om, v in zip(omega[keep].ravel(), val[keep].ravel()):
                poles.append((float(om), float(np.real(v))))
            total += float(val.sum().real)
        return poles, total


class GrandCanonicalFTLM:
    """Lanczos-scalable grand-canonical sweep: per-sector ln Z(beta)
    and <E>(beta) from the FTLM stochastic-trace estimator
    (engine/ftlm.py) instead of full spectra, combined over sectors as

        Z_gc(beta, mu) = sum_s e^{beta mu N_s} Z_s(beta).

    The reference's pipeline (thermal.cpp + grandCanonical.pl) needs
    the COMPLETE spectrum of every sector — dense O(dim^3) — so it
    cannot leave ~1e4-dim sectors; this estimator runs on the batched
    SpMM recurrence and reaches every sector the Lanczos solver does.
    Sectors at or below `dense_cutoff` use the exact dense spectrum
    (there FTLM's random-vector trace is pure overhead).

    Betas are fixed at construction (the per-sector estimates are
    computed once over the grid); mu stays a free parameter of every
    query, exactly like `GrandCanonical`."""

    def __init__(self, model, nsite: int, beta_grid,
                 kind: str = "hubbard",
                 max_electrons: Optional[int] = None,
                 num_vectors: int = 16, steps: int = 60,
                 dense_cutoff: int = 256, seed: int = 982451653,
                 dtype=np.float64, factored: bool = False, mesh=None):
        from lanczosplusplus_tpu.engine.ftlm import ftlm

        self.beta_grid = np.asarray(beta_grid, dtype=np.float64)
        self.model = model
        self.nsite = nsite
        # per sector: (nelectrons, log_z (T,), energy (T,), energy2 (T,))
        self.sector_data: List[tuple] = []
        nmax = max_electrons if max_electrons is not None else 2 * nsite
        for parts in _sector_parts_list(model, nsite, kind, nmax):
            try:
                basis = model.create_basis(parts)
            except Exception:
                continue
            if basis.size == 0:
                continue
            ne = parts[1] if kind == "heisenberg" else sum(parts)
            if basis.size <= dense_cutoff:
                spec = full_spectrum(model, basis, dtype=dtype,
                                     nelectrons=ne)
                e = spec.evals
                a = -self.beta_grid[:, None] * e[None, :]
                shift = a.max(axis=1)
                w = np.exp(a - shift[:, None])
                log_z = shift + np.log(w.sum(axis=1))
                energy = (w * e[None, :]).sum(axis=1) / w.sum(axis=1)
                energy2 = (w * e[None, :] ** 2).sum(axis=1) \
                    / w.sum(axis=1)
            else:
                ham = None
                if factored:
                    from lanczosplusplus_tpu.models import \
                        factored_hamiltonian_or_none
                    ham = factored_hamiltonian_or_none(
                        model, basis, parts, dtype)
                    if ham is not None and hasattr(ham, "inner") \
                            and hasattr(ham, "perm"):
                        # traces are basis-independent: run in block
                        # layout, never pay the flat-order perm gather
                        ham = ham.inner
                if ham is None:
                    ham = model.hamiltonian(basis, dtype=dtype)
                if mesh is not None:
                    # row-shard each large sector's FTLM recurrence
                    # over the device mesh; the dense-cutoff sectors
                    # above stay host-side either way
                    from lanczosplusplus_tpu.parallel.mesh import \
                        distributed_ftlm
                    res = distributed_ftlm(
                        ham, mesh, self.beta_grid,
                        num_vectors=num_vectors, steps=steps,
                        seed=seed)
                else:
                    res = ftlm(ham, self.beta_grid,
                               num_vectors=num_vectors,
                               steps=steps, seed=seed)
                log_z = res.log_z
                energy = res.energy
                energy2 = res.energy2
            self.sector_data.append((int(ne), log_z, energy, energy2))

    def _beta_index(self, beta: float) -> int:
        i = int(np.argmin(np.abs(self.beta_grid - beta)))
        if abs(self.beta_grid[i] - beta) > 1e-9 * max(1.0, abs(beta)):
            raise ValueError(
                f"beta={beta} not on the construction grid "
                f"{self.beta_grid}")
        return i

    def _weights(self, beta: float, mu: float, constant: float):
        """Stabilized per-sector grand-canonical weights
        w_s = exp(beta (mu N_s + constant) + ln Z_s - shift)."""
        i = self._beta_index(beta)
        logw = np.asarray([beta * (mu * ne + constant) + log_z[i]
                           for (ne, log_z, _, _) in self.sector_data])
        shift = logw.max()
        return np.exp(logw - shift), shift, i

    def log_partition(self, beta: float, mu: float,
                      constant: float = 0.0) -> float:
        w, shift, _ = self._weights(beta, mu, constant)
        return float(shift + np.log(w.sum()))

    def density(self, beta: float, mu: float,
                constant: float = 0.0) -> float:
        w, _, _ = self._weights(beta, mu, constant)
        num = sum(wi * ne for wi, (ne, _, _, _)
                  in zip(w, self.sector_data))
        return float(num / w.sum())

    def energy(self, beta: float, mu: float,
               constant: float = 0.0) -> float:
        w, _, i = self._weights(beta, mu, constant)
        num = sum(wi * e[i] for wi, (_, _, e, _)
                  in zip(w, self.sector_data))
        return float(num / w.sum())

    def specific_heat(self, beta: float, mu: float,
                      constant: float = 0.0) -> float:
        """Cv(beta, mu) = beta^2 (<H^2>_gc - <H>_gc^2) at constant mu,
        combining the per-sector <E> and <E^2> FTLM traces with the
        grand-canonical sector weights (the consumer of the energy2
        field; reference full-spectrum analogue: thermal.cpp:192-232
        Boltzmann sums)."""
        w, _, i = self._weights(beta, mu, constant)
        z = w.sum()
        e = sum(wi * e1[i] for wi, (_, _, e1, _)
                in zip(w, self.sector_data)) / z
        e2 = sum(wi * e2v[i] for wi, (_, _, _, e2v)
                 in zip(w, self.sector_data)) / z
        return float(beta ** 2 * (e2 - e ** 2))
