"""Large-sector single-chip demo: 16-site half-filled Hubbard chain.

Hilbert dimension C(16,8)^2 = 165,636,900.  The reference cannot store
this sector (CRS ~1.1e10 nnz) and its on-the-fly pthreads apply is
~seconds per iteration; here the Kronecker factorization keeps the
hopping as two 12870-row one-spin gather maps applied along the axes
of the (12870, 12870) state matrix (the gather form; on an H100 it
beats the two dense-factor GEMMs at true f32, see PERF.md), and the
memory-light plain two-pass Lanczos (no stored Krylov basis) fits the
whole solve on one card.  `python chip_smoke.py` runs the same sector
through the CLI with refinement.

Validation: U=0 ground energy equals the analytic free-fermion value.
Then solves U=4 and prints the energy per site.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np


def main(nsite=16, u=4.0, steps=150):
    from bench import build_hamiltonian
    from lanczosplusplus_tpu.solver import lanczos as lz

    # U = 0 validation
    t0 = time.time()
    ham0, basis = build_hamiltonian(nsite, dtype=np.float32)
    print(f"build: {time.time() - t0:.1f}s dim={ham0.dim}", flush=True)
    # zero out the diagonal for the U=0 check
    import jax.numpy as jnp
    import dataclasses
    ham_u0 = dataclasses.replace(ham0, diag=jnp.zeros_like(ham0.diag))
    t0 = time.time()
    evals, vecs = lz.lowest_states_plain(ham_u0, max_steps=steps)
    dt = time.time() - t0
    ks = 2 * np.pi * np.arange(nsite) / nsite
    eps = np.sort(-2.0 * np.cos(ks))
    expect = 2 * eps[:nsite // 2].sum()
    print(f"U=0: E0={evals[0]:.6f} expect={expect:.6f} "
          f"err={abs(evals[0] - expect):.2e} solve={dt:.1f}s",
          flush=True)

    t0 = time.time()
    evals4, _ = lz.lowest_states_plain(ham0, max_steps=steps)
    dt4 = time.time() - t0
    print(f"U={u}: E0={evals4[0]:.6f} E0/site={evals4[0] / nsite:.6f} "
          f"solve={dt4:.1f}s", flush=True)
    print(f"per-iteration: {dt4 / (2 * steps) * 1e3:.0f} ms "
          f"(two passes x {steps} steps)", flush=True)


if __name__ == "__main__":
    main()
