"""SpinOrbital driver (reference: src/SpinOrbital.cpp:231-256):
builds the spin-orbital chain and prints the lowest energy from BOTH
Lanczos and dense diagonalization — an internal consistency check.

Usage: python -m lanczosplusplus_tpu.cli.spin_orbital_main nsites [twiceJ]
"""

from __future__ import annotations

import sys

import numpy as np

from lanczosplusplus_tpu.config import enable_compile_cache
from lanczosplusplus_tpu.models.spin_orbital import build_spin_orbital
from lanczosplusplus_tpu.solver import lanczos as lz


def run(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    enable_compile_cache()
    if len(argv) < 1:
        print("USAGE: spin_orbital_main nsites [twiceJ]", file=sys.stderr)
        raise SystemExit(1)
    nsites = int(argv[0])
    twice_j = int(argv[1]) if len(argv) > 1 else 2
    ham = build_spin_orbital(nsites, twice_j)
    dense = ham.to_dense()
    herm = np.abs(dense - dense.T.conj()).max()
    if herm > 1e-9:
        raise SystemExit(f"H is not Hermitian: {herm}")
    evals, _ = lz.lowest_states(ham, num_states=1, max_steps=300)
    print(f"Lanczos energy={float(evals[0]):.10g}")
    e = np.linalg.eigvalsh(dense)
    print(f"LAPACK energy={e[0]:.10g}")
    return float(evals[0]), float(e[0])


def main():
    run()


if __name__ == "__main__":
    main()
