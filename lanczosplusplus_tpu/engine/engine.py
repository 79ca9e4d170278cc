"""Engine: sector diagonalization + observables orchestration.

Functional re-design of the reference Engine (reference:
src/Engine/Engine.h:84-98 ctor diagonalizes; 601-657
computeAllStatesBelow; observable entry points 113-389).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


from lanczosplusplus_tpu.config import Config, matmul_precision
from lanczosplusplus_tpu.solver import lanczos as lz
from lanczosplusplus_tpu.engine import operators as ops
from lanczosplusplus_tpu.engine.operators import LabeledOperator
from lanczosplusplus_tpu.engine.spectral import (
    ContinuedFraction, ContinuedFractionCollection)


def apply_operator_map(tgt, amp, dst_dim, vec, factor=1.0):
    """z[tgt] += factor * amp * vec — the vectorized accModifiedState_
    scatter (reference: Engine.h:416-458).  Small sectors scatter on
    host; large ones as a device scatter-add (sector-to-sector operator
    application is itself a sparse-matrix apply)."""
    src = np.asarray(vec)
    out_dtype = np.result_type(src.dtype, np.asarray(factor).dtype,
                               np.float64)
    mask = tgt >= 0
    if dst_dim >= (1 << 20):
        safe_tgt = jnp.asarray(np.where(mask, tgt, 0))
        contrib = jnp.asarray(
            np.where(mask, factor * amp * src, 0).astype(out_dtype))
        out = jnp.zeros(dst_dim, out_dtype).at[safe_tgt].add(contrib)
        return np.asarray(out)
    out = np.zeros(dst_dim, dtype=out_dtype)
    np.add.at(out, tgt[mask], factor * amp[mask] * src[mask])
    return out


class Engine:
    """Diagonalizes the target sector on construction and serves
    energies/eigenvectors plus observable calculations."""

    def __init__(self, model, inp, config: Config | None = None):
        from lanczosplusplus_tpu.utils.progress import ProgressIndicator

        self.progress = ProgressIndicator("Engine")
        self.model = model
        self.inp = inp
        self.config = config or Config(
            use_complex="useComplex" in inp.solver_options(),
            lanczos_steps=inp.integer("LanczosSteps", default=200),
            lanczos_eps=inp.real("LanczosEps", default=1e-12))
        self.excited = inp.integer("Excited", default=0)
        self.parts = model.default_parts(inp)
        with self.progress.phase("basis"):
            self.basis = model.create_basis(self.parts)
        self._flat_ham = None
        nstates = self.excited + 1
        use_symmetry = (inp.integer("UseTranslationSymmetry", default=0) or
                        inp.integer("UseReflectionSymmetry", default=0))
        self._factored = False
        self.factored_fallback_reason = None
        if "factored" in inp.solver_options() and not use_symmetry:
            # attempt the block factorization; models/inputs without
            # one (or with restrictions the factored builders cannot
            # serve) fall back to the flat gather path LOUDLY
            ham_f = self._factored_hamiltonian(
                self.parts, self.basis, warn=self._warn_fallback)
            if ham_f is not None:
                self._factored = True
                self._ham_cache = {self.parts: ham_f}
        use_factored = self._factored
        if not (use_symmetry or use_factored):
            with self.progress.phase("hamiltonian"):
                ham = self.hamiltonian
        with self.progress.phase("diagonalization",
                                 f"dim={self.basis.size}"):
            if use_symmetry:
                self._solve_with_symmetry(inp, nstates)
            elif use_factored:
                self._solve_factored(nstates)
            else:
                self._energies, self._vectors, info = lz.lowest_states(
                    ham, num_states=nstates,
                    seed=self.config.seed,
                    max_steps=self.config.lanczos_steps,
                    return_info=True)
                self._log_solve(info)

    def _warn_fallback(self, reason: str):
        self.factored_fallback_reason = reason
        self.progress(f"WARNING: {reason}")

    def _log_solve(self, info):
        """Reference-style convergence report (Engine.h:624-639 prints
        'lanczos solver failed ... trying fullDiag')."""
        info.factored_fallback = self.factored_fallback_reason
        self.solve_info = info
        if info.used_dense_fallback and info.steps:
            self.progress(
                "Lanczos did not converge (relative residual "
                f"{info.residual:.3e} after {info.steps} steps); "
                "used dense fullDiag fallback")
        elif not info.converged:
            self.progress(
                "WARNING: Lanczos unconverged (relative residual "
                f"{info.residual:.3e} after {info.steps} steps) and "
                "sector too large for dense fallback")

    @property
    def hamiltonian(self):
        """Flat sector Hamiltonian, built lazily so factored solves can
        skip it entirely unless observables need it."""
        if self._flat_ham is None:
            self._flat_ham = self.model.hamiltonian(
                self.basis, dtype=self.config.scalar_dtype)
        return self._flat_ham

    def _solve_factored(self, nstates):
        """Heisenberg (any S) / Kitaev / Rashba / t-J / FeAs-SO via the
        half-cut block factorization (SolverOptions=factored): the hot
        ops are dense GEMMs and the flat ELL is never materialized for
        the solve."""
        ham = self._cached_hamiltonian(self.parts)
        evals, vecs, info = lz.lowest_states(
            ham, num_states=nstates, seed=self.config.seed,
            max_steps=self.config.lanczos_steps, return_info=True)
        self._log_solve(info)
        self._energies = evals
        self._vectors = [np.asarray(v) for v in vecs]

    def _factored_hamiltonian(self, parts, basis, warn=None):
        """Flat-ordered block-factorized Hamiltonian or None: Sz-blocked
        half-cut for a Heisenberg sector of any spin S (any szpc, so
        dynamic-run sectors from s+/s- use it too), plain half-cut
        Kronecker for Kitaev (full 2^n, flat order is already the
        product order), block-Kronecker unions for Rashba / t-J /
        FeAs spin-orbit.

        SolverOptions=factored,bf16cross additionally stores the
        cut-crossing amplitude tables in bfloat16 (real scalars only):
        ~4e-4-level matvec quantization the RQI refinement removes
        from final energies via its unquantized host-f64 residual —
        a throughput knob for the gather-bound cross path."""
        from lanczosplusplus_tpu.models import factored_hamiltonian_or_none

        cross_dtype = None
        if "bf16cross" in self.inp.solver_options() \
                and not self.config.use_complex:
            cross_dtype = jnp.bfloat16
        return factored_hamiltonian_or_none(
            self.model, basis, parts, self.config.scalar_dtype,
            warn=warn, cross_dtype=cross_dtype)

    def _solve_with_symmetry(self, inp, nstates):
        """Sector scan keeping the lowest states (reference:
        Engine.h:601-657 computeAllStatesBelow over symmetry sectors).

        The winning block's SolveInfo is logged/exposed (a silently
        unconverged or dense-fallback block solve previously reported
        nothing)."""
        from lanczosplusplus_tpu.symmetry import build_symmetry

        if self._try_projected_translation(inp, nstates):
            return
        fermionic = getattr(self.model, "is_fermionic", True)
        sym = build_symmetry(inp, self.basis, self.model.geometry,
                             self.model, fermionic=fermionic)
        best = None
        for s in range(sym.sectors()):
            ham_s = sym.block_hamiltonian(s)
            if ham_s is None or ham_s.dim == 0:
                continue
            evals, vecs, info = lz.lowest_states(
                ham_s, num_states=min(nstates, ham_s.dim),
                seed=self.config.seed,
                max_steps=self.config.lanczos_steps,
                return_info=True)
            if not info.converged:
                self.progress(
                    f"WARNING: symmetry block {s} unconverged "
                    f"(relative residual {info.residual:.3e} after "
                    f"{info.steps} steps)")
            if best is None or evals[0] < best[0][0]:
                best = (evals, vecs, s, info)
        evals, vecs, sector, info = best
        self._log_solve(info)
        self.solve_sector = sector
        self._energies = evals
        self._vectors = [sym.transform(np.asarray(v), sector)
                         for v in vecs]

    def _try_projected_translation(self, inp, nstates) -> bool:
        """Momentum sectors via projected Lanczos in the FULL space
        (symmetry/projected.py) when SolverOptions=projected asks for
        it, the basis index is the bit word and translation is the +1
        cyclic site shift (Kitaev chain): the projector is pure
        reshape-transposes, so each sector solves at factored-matvec
        speed.  Returns False (→ the assembled orbit-block path, the
        reference-shaped algorithm) when not asked or out of scope."""
        if "projected" not in inp.solver_options():
            return False
        if inp.integer("UseTranslationSymmetry", default=0) != 1:
            return False
        if inp.integer("UseReflectionSymmetry", default=0):
            return False
        if type(self.model).__name__ != "KitaevModel":
            return False
        n = self.model.geometry.number_of_sites()
        if self.basis.size != (1 << n):
            return False
        try:
            perm = [self.model.geometry.translate(s, 0, 1)
                    for s in range(n)]
        except Exception:
            return False
        if perm != [(s + 1) % n for s in range(n)]:
            return False
        try:
            from lanczosplusplus_tpu.models.kitaev_factored import \
                build_factored_kitaev
            ham = build_factored_kitaev(self.model, self.basis,
                                        dtype=self.config.scalar_dtype)
        except NotImplementedError:
            return False
        from lanczosplusplus_tpu.symmetry.projected import \
            ProjectedTranslationSolver
        proj = ProjectedTranslationSolver(ham, n)
        best = None
        for s in range(proj.sectors()):
            evals, vecs, info = proj.solve_sector(
                s, num_states=nstates,
                max_steps=self.config.lanczos_steps,
                seed=self.config.seed)
            if not info.converged:
                self.progress(
                    f"WARNING: momentum sector k={proj.momentum(s)} "
                    f"unconverged (relative residual "
                    f"{info.residual:.3e})")
            if best is None or evals[0] < best[0][0]:
                best = (evals, vecs, s, info)
        evals, vecs, sector, info = best
        self._log_solve(info)
        self.solve_sector = proj.momentum(sector)
        self.projected_purity = proj.purity(sector, vecs[0])
        self.progress(
            f"projected translation: min-k sector k={self.solve_sector}"
            f" purity={self.projected_purity:.6f}")
        self._energies = evals
        self._vectors = [np.asarray(v) for v in vecs]
        return True

    def energies(self, i: int = 0) -> float:
        return float(self._energies[i])

    def eigenvector(self, i: int = 0):
        return self._vectors[i]

    @property
    def ground_energy(self) -> float:
        return self.energies(0)

    # -- sector caches (spectral pipelines revisit the same N+-1
    #    sectors for every site pair / operator type) ---------------------

    def _cached_basis(self, parts):
        if not hasattr(self, "_basis_cache"):
            self._basis_cache = {self.parts: self.basis}
        if parts not in self._basis_cache:
            self._basis_cache[parts] = self.model.create_basis(parts)
        return self._basis_cache[parts]

    def _cached_hamiltonian(self, parts):
        if not hasattr(self, "_ham_cache"):
            self._ham_cache = {}
        if parts not in self._ham_cache:
            ham = None
            if getattr(self, "_factored", False):
                ham = self._factored_hamiltonian(
                    parts, self._cached_basis(parts))
            if ham is None:
                ham = self.model.hamiltonian(
                    self._cached_basis(parts),
                    dtype=self.config.scalar_dtype)
            self._ham_cache[parts] = ham
        return self._ham_cache[parts]

    def _cached_dense_hamiltonian(self, parts):
        """Dense-factor (GEMM) form of a sector Hamiltonian for
        batched recurrences: the index-gather SpMM path materializes a
        (R, dim)-sized intermediate per hop factor, which blows HBM at
        large dims x batch; the densified Kronecker factors make each
        block step two GEMMs instead."""
        if not hasattr(self, "_dense_ham_cache"):
            self._dense_ham_cache = {}
        if parts not in self._dense_ham_cache:
            h = self._cached_hamiltonian(parts)
            if hasattr(h, "densify_factors"):
                h = h.densify_factors()
            self._dense_ham_cache[parts] = h
        return self._dense_ham_cache[parts]

    # -- operator application across sectors ------------------------------

    def _get_needed_basis(self, parts, op, spin, orb):
        """(new_parts, basis) or None (reference: Engine.h:391-414)."""
        if not op.needs_new_basis:
            if parts == self.parts:
                return parts, self.basis
            return parts, self._cached_basis(parts)
        new_parts = self.model.has_new_parts(parts, op, spin, orb)
        if new_parts is None:
            return None
        return new_parts, self._cached_basis(new_parts)

    def acc_modified_state(self, z, op, dst_basis, src_vec, src_basis,
                           site, spin, orb, factor):
        """z += factor * op_site |src> (reference: Engine.h:416-458)."""
        tgt, amp, dst_dim = self._cached_operator_map(
            op, site, spin, orb, src_basis, dst_basis)
        z += apply_operator_map(tgt, amp, dst_dim, src_vec, factor)
        return z

    def _acc_modified_state_dressed(self, z, op, dst_basis, src_vec,
                                    src_basis, site, spin, orb, isign):
        """The twoPoint variant: sz -> 0.5 n_up - 0.5 n_down
        (reference: Engine.h:537-599 accModifiedState)."""
        if op.name == ops.SZ:
            op_n = LabeledOperator(ops.N)
            self.acc_modified_state(z, op_n, dst_basis, src_vec, src_basis,
                                    site, 0, orb, isign * 0.5)
            self.acc_modified_state(z, op_n, dst_basis, src_vec, src_basis,
                                    site, 1, orb, -isign * 0.5)
            return z
        return self.acc_modified_state(z, op, dst_basis, src_vec, src_basis,
                                       site, spin, orb, isign)

    # -- spectral functions (reference: Engine.h:113-206) -----------------

    def spectral_function(self, op_name: str, isite: int, jsite: int,
                          spin: int = 0, orbs=(0, 0)):
        """Green's function G_op(isite, jsite, omega) as a
        continued-fraction collection via the 4-type decomposition
        (reference: Engine.h:133-206 spectralFunction)."""
        op1 = LabeledOperator(op_name)
        op2 = op1.transpose_conjugate()
        gs = np.asarray(self.eigenvector(0))
        is_diagonal = (isite == jsite and orbs[0] == orbs[1])
        coll = ContinuedFractionCollection()
        labels = []
        for type_ in range(op1.number_of_types):
            if is_diagonal and type_ > 1:
                continue
            op = op1 if (type_ & 1) else op2
            if op.needs_new_basis:
                new_parts = self.model.has_new_parts(
                    self.parts, op, spin, orbs[0])
                if new_parts is None:
                    continue
                basis_new = self._cached_basis(new_parts)
            else:
                new_parts = self.parts
                basis_new = self.basis
            modif = np.zeros(basis_new.size, dtype=gs.dtype)
            self.acc_modified_state(modif, op, basis_new, gs, self.basis,
                                    isite, spin, orbs[0], 1.0)
            if not is_diagonal:
                isign = -1.0 if type_ > 1 else 1.0
                self.acc_modified_state(modif, op, basis_new, gs, self.basis,
                                        jsite, spin, orbs[1], isign)
            ham_new = self._cached_hamiltonian(new_parts)
            cf = self._calc_spectral(ham_new, op.is_fermionic, modif,
                                     type_, is_diagonal)
            cf.meta = f"{spin},{type_},{orbs[0]},{orbs[1]}"
            labels.append(cf.meta)
            coll.push(cf)
        return coll, labels

    def spectral_functions_batched(self, op_name: str, pairs,
                                   spin: int = 0, orbs=(0, 0)):
        """Continued fractions for MANY site pairs at once.

        Same 4-type decomposition, weights and output as
        `spectral_function`, but every (pair, type) job that lands in
        the same destination sector runs inside ONE batched SpMM
        recurrence (`tridiagonalize_plain_batched`) — the whole
        TSPCenter / DoAllPairs / DOS fleet costs two batched Lanczos
        dispatches (N+1 and N-1 sectors) instead of ~4x len(pairs)
        serial runs (reference: LanczosDriver1.h:138-183 loops
        engine.spectralFunction per pair).  The tridiagonals come from
        the plain (no-reorthogonalization) recurrence, the reference's
        own decomposition mode (Engine.h:472-478 LanczosSolver
        decomposition).

        Returns a list of (ContinuedFractionCollection, labels), one
        per entry of `pairs`."""
        import jax
        import jax.numpy as jnp

        op1 = LabeledOperator(op_name)
        op2 = op1.transpose_conjugate()
        gs = np.asarray(self.eigenvector(0))
        steps = self.inp.integer("SpectralSteps",
                                 default=self.config.lanczos_steps)
        x64 = jax.config.read("jax_enable_x64")
        fleet_dtype = (np.complex128 if x64 else np.complex64) \
            if np.iscomplexobj(gs) else (np.float64 if x64 else np.float32)
        per_pair_items = [[] for _ in pairs]
        # ONE batched device scatter per (op, orb, dst sector) builds
        # op_site|gs> for every site; each (pair, type) start vector is
        # then two device row reads + one axpy.  The host operator maps
        # behind the scatter plan are built exactly once per sector and
        # cached (reference: Engine.h:416-458 rebuilds the per-site
        # application for every pair and type).
        z_cache = {}

        def z_for(op, basis_new, orb_):
            zkey = (op.name, orb_, id(basis_new))
            if zkey not in z_cache:
                valid, Z = self._batched_modified_states(
                    op, basis_new, gs, spin, orb_, dressed=False)
                z_cache[zkey] = ({s_: k for k, s_ in enumerate(valid)}, Z)
            return z_cache[zkey]

        # parts -> (basis_new, jobs); job = (pi, slot, s, s2, meta, spec)
        pending = {}
        for pi, (isite, jsite) in enumerate(pairs):
            is_diagonal = (isite == jsite and orbs[0] == orbs[1])
            for type_ in range(op1.number_of_types):
                if is_diagonal and type_ > 1:
                    continue
                op = op1 if (type_ & 1) else op2
                if op.needs_new_basis:
                    new_parts = self.model.has_new_parts(
                        self.parts, op, spin, orbs[0])
                    if new_parts is None:
                        continue
                    basis_new = self._cached_basis(new_parts)
                else:
                    new_parts = self.parts
                    basis_new = self.basis
                s, s2 = self._spectral_signs(op.is_fermionic, type_,
                                             is_diagonal)
                meta = f"{spin},{type_},{orbs[0]},{orbs[1]}"
                slot = len(per_pair_items[pi])
                per_pair_items[pi].append(None)
                isign = 0.0 if is_diagonal else \
                    (-1.0 if type_ > 1 else 1.0)
                key = tuple(new_parts) if not isinstance(new_parts, tuple) \
                    else new_parts
                pending.setdefault(key, (basis_new, []))[1].append(
                    (pi, slot, s, s2, meta, (op, isite, jsite, isign)))
        for parts_key, (basis_new, jobs) in pending.items():
            rows = []
            for (_, _, _, _, _, (op, isite, jsite, isign)) in jobs:
                pos_i, Z_i = z_for(op, basis_new, orbs[0])
                row = Z_i[pos_i[isite]] if isite in pos_i else None
                if isign != 0.0:
                    pos_j, Z_j = z_for(op, basis_new, orbs[1])
                    zj = Z_j[pos_j[jsite]] if jsite in pos_j else None
                    if zj is not None:
                        row = isign * zj if row is None else \
                            row + isign * zj
                rows.append(jnp.zeros(basis_new.size, fleet_dtype)
                            if row is None else row)
            M = jnp.stack(rows)
            weights = np.asarray(
                jnp.sum(jnp.abs(M) ** 2, axis=1)).astype(np.float64)
            live = weights >= 1e-24
            for j, (pi, slot, s, s2, meta, _) in enumerate(jobs):
                if not live[j]:
                    per_pair_items[pi][slot] = ContinuedFraction(
                        alphas=np.zeros(0), betas=np.zeros(0),
                        e0=self.ground_energy, weight=0.0, sigma=s,
                        meta=meta)
            if not live.any():
                continue
            ham_new = self._cached_dense_hamiltonian(parts_key)
            v0s = (M[np.nonzero(live)[0]] /
                   jnp.sqrt(jnp.asarray(weights[live],
                                        M.dtype))[:, None])
            ress = lz.tridiagonalize_plain_batched(ham_new, v0s, steps)
            live_jobs = [j for j, ok in zip(jobs, live) if ok]
            for (pi, slot, s, s2, meta, _), res, w in zip(
                    live_jobs, ress, weights[live]):
                per_pair_items[pi][slot] = ContinuedFraction(
                    alphas=res.alphas, betas=res.betas,
                    e0=self.ground_energy, weight=w * s2, sigma=s,
                    meta=meta)
        out = []
        for items in per_pair_items:
            coll = ContinuedFractionCollection()
            labels = []
            for cf in items:
                coll.push(cf)
                labels.append(cf.meta)
            out.append((coll, labels))
        return out

    @staticmethod
    def _spectral_signs(is_fermionic, type_, is_diagonal):
        """(s, s2) of the 4-type decomposition (Engine.h:139-158):
        s is the pole direction (sigma), s2 the CF weight sign."""
        s = -1 if (type_ & 1) else 1
        s2 = -1.0 if type_ > 1 else 1.0
        if not is_fermionic:
            s2 *= s
        if not is_diagonal:
            s2 *= 0.5
        return s, s2

    def _calc_spectral(self, ham_new, is_fermionic, modif, type_,
                       is_diagonal) -> ContinuedFraction:
        """Lanczos tridiagonalization of op|gs> (reference:
        Engine.h:460-490 calcSpectral)."""
        import jax.numpy as jnp

        weight = float(np.real(np.vdot(modif, modif)))
        s, s2 = self._spectral_signs(is_fermionic, type_, is_diagonal)
        # our sigma convention: +1 = particle addition (poles at
        # omega = E_n - E0); even types apply the transpose-conjugate
        # operator (c^dagger for gf "c"), odd types remove.  The
        # reference passes -s to PsimagLite cf.set whose internal
        # convention is mirrored (Engine.h:488).
        if weight < 1e-24:
            return ContinuedFraction(
                alphas=np.zeros(0), betas=np.zeros(0),
                e0=self.ground_energy, weight=0.0, sigma=s)
        v0 = jnp.asarray(modif / np.sqrt(weight))
        # the reference reads a separate "Spectral" solver section
        # (Engine.h:472 ParametersForSolver(io, "Spectral"))
        steps = self.inp.integer("SpectralSteps",
                                 default=self.config.lanczos_steps)
        itemsize = np.dtype(ham_new.dtype).itemsize
        if (min(ham_new.dim, steps) * ham_new.dim * itemsize
                > lz.default_krylov_budget_bytes()):
            # huge sector: the CF needs only (alpha, beta)
            res = lz.tridiagonalize_plain(ham_new, v0, steps)
        else:
            res = lz.tridiagonalize(ham_new, v0, steps)
        return ContinuedFraction(
            alphas=res.alphas, betas=res.betas, e0=self.ground_energy,
            weight=weight * s2, sigma=s)

    def kpm_local_dos(self, op_name: str, isite: int, omegas,
                      spin: int = 0, orb: int = 0,
                      num_moments: int = 512):
        """N_i(omega) by the kernel polynomial method: the diagonal
        spectral function (types 0/1 of Engine.h:133-206) evaluated as
        a Jackson-broadened Chebyshev density instead of a Lanczos
        continued fraction.  Addition poles land at
        omega = E_n - E0 > 0, removal poles are mirrored to
        omega = E0 - E_n < 0.  Scales to destination sectors where the
        stored-V Lanczos basis would not fit (O(2 vectors) memory, no
        reorthogonalization)."""
        from lanczosplusplus_tpu.engine.kpm import kpm_spectral

        op1 = LabeledOperator(op_name)
        op2 = op1.transpose_conjugate()
        gs = np.asarray(self.eigenvector(0))
        omegas = np.asarray(omegas, dtype=np.float64)
        total = np.zeros_like(omegas)
        for type_ in range(2):
            op = op1 if (type_ & 1) else op2
            if op.needs_new_basis:
                new_parts = self.model.has_new_parts(
                    self.parts, op, spin, orb)
                if new_parts is None:
                    continue
                basis_new = self._cached_basis(new_parts)
            else:
                new_parts = self.parts
                basis_new = self.basis
            modif = np.zeros(basis_new.size, dtype=gs.dtype)
            self.acc_modified_state(modif, op, basis_new, gs, self.basis,
                                    isite, spin, orb, 1.0)
            if np.vdot(modif, modif).real < 1e-24:
                continue
            ham_new = self._cached_hamiltonian(new_parts)
            grid = omegas if type_ == 0 else -omegas
            # removal-branch sign matches the continued-fraction path
            # (_calc_spectral): commutator form for non-fermionic ops
            sgn = -1.0 if (type_ == 1 and not op1.is_fermionic) else 1.0
            total = total + sgn * kpm_spectral(
                ham_new, modif, grid, self.ground_energy,
                num_moments=num_moments)
        return total

    def ftlm_local_dos(self, op_name: str, isite: int, beta: float,
                       omegas, delta: float = 0.1, spin: int = 0,
                       orb: int = 0, num_vectors: int = 16,
                       steps: int = 100, seed: int = 152917,
                       start_vectors=None):
        """N_i(omega, T): FINITE-TEMPERATURE local spectral function by
        the FTLM double-Krylov estimator (engine/ftlm_dynamic.py) —
        addition part plus mirrored removal part, Lorentzian-broadened.
        The reference reaches finite-T dynamics only through full
        spectra of every sector (thermal.cpp + grandCanonical.pl); this
        scales to sectors where dense diagonalization is impossible.
        Normalization: source-sector canonical ensemble.  The mirrored
        removal branch carries the SAME sign convention as the
        continued-fraction path (_calc_spectral): negative for
        non-fermionic operators (commutator form), positive for
        fermionic ones."""
        from lanczosplusplus_tpu.engine.ftlm_dynamic import (
            ftlm_dynamic, ftlm_source_runs)
        from lanczosplusplus_tpu.solver.lanczos import random_start_block

        op1 = LabeledOperator(op_name)
        op2 = op1.transpose_conjugate()
        omegas = np.asarray(omegas, dtype=np.float64)
        total = np.zeros_like(omegas)
        ham_src = self.hamiltonian
        # the source-sector Lanczos fleet is identical for both
        # operator types: run it once and share
        if start_vectors is None:
            start_vectors = np.asarray(random_start_block(
                ham_src.dim, num_vectors, seed, ham_src.dtype))
        src_steps = int(min(steps, ham_src.dim))
        shared_runs = ftlm_source_runs(ham_src, np.asarray(start_vectors),
                                       src_steps)
        for type_ in range(2):
            op = op1 if (type_ & 1) else op2
            if op.needs_new_basis:
                new_parts = self.model.has_new_parts(
                    self.parts, op, spin, orb)
                if new_parts is None:
                    continue
                basis_new = self._cached_basis(new_parts)
                ham_new = self._cached_hamiltonian(new_parts)
            else:
                basis_new = self.basis
                ham_new = ham_src

            def apply(v, _op=op, _basis=basis_new):
                z = np.zeros(_basis.size,
                             dtype=np.result_type(v.dtype, np.float64))
                self.acc_modified_state(z, _op, _basis, np.asarray(v),
                                        self.basis, isite, spin, orb, 1.0)
                return z

            dyn = ftlm_dynamic(ham_src, ham_new, apply,
                               num_vectors=num_vectors, steps=steps,
                               seed=seed, start_vectors=start_vectors,
                               source_runs=shared_runs)
            grid = omegas if type_ == 0 else -omegas
            sgn = -1.0 if (type_ == 1 and not op1.is_fermionic) else 1.0
            total = total + sgn * dyn.evaluate(beta, grid, delta)
        return total

    def ftlm_sq_omega(self, op_name: str, beta: float, omegas,
                      delta: float = 0.1, spin: int = 0, orb: int = 0,
                      num_vectors: int = 16, steps: int = 100,
                      seed: int = 152917, start_vectors=None):
        """S(q, omega) at FINITE temperature for a sector-preserving
        operator (sz, n): S_q(w) = (1/Z) sum_nm e^{-b E_n}
        |<m|B_q|n>|^2 delta(w - E_m + E_n) with
        B_q = sum_j e^{iq r_j} op_j, estimated by the FTLM
        double-Krylov method.  The complex momentum operator splits
        into REAL cos/sin combinations (S_q = S_cos + S_sin since the
        cross terms assemble cos(q(r_i - r_j))), so the Hamiltonian
        stays real; ONE source-sector Lanczos fleet is shared across
        every momentum.  The reference reaches S(q, w) only at T=0
        (sqomega.pl over ground-state continued fractions) or through
        full spectra.  Returns (qs, S[len(qs), len(omegas)])."""
        from lanczosplusplus_tpu.engine.ftlm_dynamic import (
            ftlm_dynamic, ftlm_source_runs)
        from lanczosplusplus_tpu.solver.lanczos import random_start_block

        op = LabeledOperator(op_name)
        if op.needs_new_basis:
            raise ValueError("ftlm_sq_omega: sector-preserving "
                             "operators only (sz, n)")
        ham = self.hamiltonian
        if jnp.issubdtype(jnp.dtype(ham.dtype), jnp.complexfloating):
            # the cos/sin split S_q = S_cos + S_sin needs real matrix
            # elements; with complex eigenvectors the cross term
            # -2 Im(<m|C|n>* <m|S|n>) survives and the sum would
            # silently yield (S_q + S_-q)/2
            raise ValueError("ftlm_sq_omega: real Hamiltonians only "
                             "(complex eigenvectors break the cos/sin "
                             "momentum decomposition)")
        nsite = self.geometry.number_of_sites()
        omegas = np.asarray(omegas, dtype=np.float64)
        if start_vectors is None:
            start_vectors = np.asarray(random_start_block(
                ham.dim, num_vectors, seed, ham.dtype))
        V0 = np.asarray(start_vectors)
        src_steps = int(min(steps, ham.dim))
        shared = ftlm_source_runs(ham, V0, src_steps)
        # per-site operator index maps built ONCE (apply() runs for
        # every Krylov row of every run of every momentum — rebuilding
        # the maps there dominated the whole estimator)
        site_maps = [self.model.operator_map(op, site, spin, orb,
                                             self.basis, self.basis)
                     for site in range(nsite)]
        qs = 2.0 * np.pi * np.arange(nsite) / nsite
        out = np.zeros((nsite, omegas.shape[0]))
        for iq, q in enumerate(qs):
            for phase in (np.cos, np.sin):
                wsites = phase(q * np.arange(nsite))
                if np.abs(wsites).max() < 1e-14:
                    continue

                def apply(v, _w=wsites):
                    z = np.zeros(self.basis.size,
                                 dtype=np.result_type(v.dtype,
                                                      np.float64))
                    src = np.asarray(v)
                    for site in range(nsite):
                        if abs(_w[site]) < 1e-14:
                            continue
                        tgt, amp, dst_dim = site_maps[site]
                        z += apply_operator_map(tgt, amp, dst_dim,
                                                src, _w[site])
                    return z

                dyn = ftlm_dynamic(ham, ham, apply, steps=steps,
                                   start_vectors=V0,
                                   source_runs=shared)
                out[iq] += dyn.evaluate(beta, omegas, delta)
        return qs, out

    # -- static correlators (reference: Engine.h:266-338) -----------------

    def _cached_operator_map(self, op, site, spin, orb, src_basis,
                             dst_basis=None):
        """Per-(op, site, spin, orb, src-sector, dst-sector) index-map
        cache: the host-side map construction dominates repeated
        observable calls at large dims (spectral fleets, two_point,
        sq_omega, kpm/ftlm local DOS — every acc_modified_state goes
        through here).  The cached entry holds references to both bases
        so the id()-based key can never alias a garbage-collected
        basis."""
        if dst_basis is None:
            src_basis, dst_basis = self.basis, src_basis
        if not hasattr(self, "_opmap_cache"):
            self._opmap_cache = {}
        key = (op.name, site, spin, orb, id(src_basis), id(dst_basis))
        if key not in self._opmap_cache:
            self._opmap_cache[key] = (
                src_basis, dst_basis,
                self.model.operator_map(op, site, spin, orb,
                                        src_basis, dst_basis))
        return self._opmap_cache[key][2]

    def _batched_scatter_plan(self, op, dst_basis, spin, orb, dtype,
                              dressed=True):
        """Device-resident batched scatter plan for op_site |vec> over
        all sites: (valid_sites, rows, tgts, src_idx, amps).  Cached so
        repeated observable calls ship only the state vector to the
        device (the index maps and amplitudes stay put).  `dressed`
        applies the twoPoint sz -> (n_up - n_down)/2 decomposition
        (Engine.h:537-599); spectral fleets pass dressed=False and use
        the model's native sz map (Engine.h:416-458)."""
        if not hasattr(self, "_scatter_plan_cache"):
            self._scatter_plan_cache = {}
        key = (op.name, spin, orb, id(dst_basis), np.dtype(dtype).name,
               dressed)
        if key in self._scatter_plan_cache:
            return self._scatter_plan_cache[key]
        n = self.geometry.number_of_sites()
        rows_l, tgt_l, src_l, amp_l = [], [], [], []
        valid = []
        for site in range(n):
            if orb >= self.model.orbitals(site):
                continue
            k = len(valid)
            valid.append(site)
            if dressed and op.name == ops.SZ:
                # sz -> 0.5 n_up - 0.5 n_down (Engine.h:537-599)
                parts_ = [(LabeledOperator(ops.N), 0, 0.5),
                          (LabeledOperator(ops.N), 1, -0.5)]
            else:
                parts_ = [(op, spin, 1.0)]
            for (op_k, spin_k, factor) in parts_:
                tgt, amp, _ = self._cached_operator_map(
                    op_k, site, spin_k, orb, dst_basis)
                mask = tgt >= 0
                rows_l.append(np.full(mask.sum(), k, np.int32))
                tgt_l.append(tgt[mask].astype(np.int32))
                src_l.append(np.nonzero(mask)[0].astype(np.int32))
                amp_l.append((factor * amp[mask]).astype(dtype))
        plan = None
        if valid:
            plan = (valid,
                    jnp.asarray(np.concatenate(rows_l)),
                    jnp.asarray(np.concatenate(tgt_l)),
                    jnp.asarray(np.concatenate(src_l)),
                    jnp.asarray(np.concatenate(amp_l)))
        self._scatter_plan_cache[key] = plan
        return plan

    def _batched_modified_states(self, op, dst_basis, vec, spin, orb,
                                 dressed=True):
        """(valid_sites, Z): Z[k] = (dressed) op_site |vec> for every
        valid site, built as ONE device scatter-add — the batched
        accModifiedState_ (reference loops sites serially,
        Engine.h:416-458).  Z lands on the default device so the n^2
        pair overlaps can run as a single GEMM."""
        import jax

        x64 = jax.config.read("jax_enable_x64")
        cplx = np.iscomplexobj(vec)
        dtype = (np.complex128 if x64 else np.complex64) if cplx else \
            (np.float64 if x64 else np.float32)
        plan = self._batched_scatter_plan(op, dst_basis, spin, orb,
                                          dtype, dressed=dressed)
        if plan is None:
            return [], None
        valid, rows, tgts, src_idx, amps = plan
        v_dev = jnp.asarray(np.asarray(vec).astype(dtype))
        contribs = amps * v_dev[src_idx]
        Z = jnp.zeros((len(valid), dst_basis.size), dtype)
        Z = Z.at[rows, tgts].add(contribs)
        return valid, Z

    def two_point(self, op_name: str, spin=(0, 0), orbs=(0, 0),
                  bra_ket=(0, 0)):
        """C(i, j) = <bra| op^dag_j op_i |ket> for all site pairs.

        All modified states build as one batched device scatter and the
        full pair matrix is ONE GEMM <Z_bra | Z_ket^T>
        (reference: Engine.h:266-338 loops pairs serially)."""
        op = LabeledOperator(op_name)
        n = self.geometry.number_of_sites()
        if op.needs_new_basis:
            if spin[0] != spin[1]:
                raise ValueError("two_point: off-diagonal spin with "
                                 "sector-changing operator unsupported")
            new_parts = self.model.has_new_parts(self.parts, op, spin[0],
                                                 orbs[0])
            if new_parts is None:
                return None
            basis_new = self._cached_basis(new_parts)
        else:
            basis_new = self.basis
        bra = np.asarray(self.eigenvector(bra_ket[0]))
        ket = np.asarray(self.eigenvector(bra_ket[1]))
        valid_i, Z_ket = self._batched_modified_states(
            op, basis_new, ket, spin[0], orbs[0])
        if (bra_ket[0] == bra_ket[1] and spin[0] == spin[1]
                and orbs[0] == orbs[1]):
            valid_j, Z_bra = valid_i, Z_ket
        else:
            valid_j, Z_bra = self._batched_modified_states(
                op, basis_new, bra, spin[1], orbs[1])
        result = np.full((n, n), np.nan, dtype=np.complex128)
        if Z_ket is None or Z_bra is None:
            return result
        # result[i, j] = <z_bra_j | z_ket_i>
        import jax
        block = np.asarray(jax.lax.dot_general(
            Z_ket, jnp.conj(Z_bra),
            dimension_numbers=(((1,), (1,)), ((), ())),
            precision=matmul_precision()))
        for a, isite in enumerate(valid_i):
            for b, jsite in enumerate(valid_j):
                result[isite, jsite] = block[a, b]
        return result

    # -- many-point fixed-site correlator (reference: Engine.h:341-389) ---

    def many_point(self, sites, op_names, spins, orbs, bra_ket=(0, 0)):
        tmp = np.asarray(self.eigenvector(bra_ket[1]))
        basis_old = self.basis
        old_parts = self.parts
        for k, site in enumerate(sites):
            if orbs[k] >= self.model.orbitals(site):
                continue
            op = LabeledOperator(op_names[k])
            got = self._get_needed_basis(old_parts, op, spins[k], orbs[k])
            if got is None:
                return 0.0
            new_parts, basis_new = got
            z = np.zeros(basis_new.size, dtype=np.complex128)
            self.acc_modified_state(z, op, basis_new, tmp, basis_old,
                                    site, spins[k], orbs[k], 1.0)
            tmp = z
            basis_old = basis_new
            old_parts = new_parts
        if old_parts != self.parts:
            return 0.0
        bra = np.asarray(self.eigenvector(bra_ket[0]))
        return complex(np.vdot(bra, tmp))

    # -- measure mini-language (reference: Engine.h:208-249) --------------

    def measure(self, bra_op_ket: str):
        """'bra|op[site];...|ket' -> <bra| ops |ket> via the rahul
        method."""
        from lanczosplusplus_tpu.engine import rahul

        parts = bra_op_ket.split("|")
        if len(parts) != 3:
            raise ValueError("measure: only dressed brakets allowed")
        bra_idx = rahul.parse_braket_level(parts[0])
        ket_idx = rahul.parse_braket_level(parts[2])
        tokens = [t for t in parts[1].split(";") if t]
        ops, sites = [], []
        for t in tokens:
            op, site = rahul.parse_op_token(t)
            ops.append(op)
            sites.append(site)
        ket = np.asarray(self.eigenvector(ket_idx))
        psi_new = rahul.rahul_apply(self.basis, ops, sites, ket)
        bra = np.asarray(self.eigenvector(bra_idx))
        return complex(np.vdot(bra, psi_new))

    @property
    def geometry(self):
        return self.model.geometry
