"""Built-in consistency oracles.

1. dual-algorithm check: solve the target sector with Lanczos AND dense
   diagonalization and print both energies (reference:
   src/SpinOrbital.cpp:198-254, which does the same for its spin-orbital
   chain; here it works for any Model= input).
2. Heisenberg infinite-temperature energy: brute-force <E> at T=inf in
   an Sz sector (reference:
   src/HeisenbergInfiniteTemperatureEnergy.cpp:58-76), computed from the
   full spectrum trace.

Usage: python -m lanczosplusplus_tpu.cli.consistency_main -f input.inp
       [--tinf]
"""

from __future__ import annotations

import argparse

import numpy as np

from lanczosplusplus_tpu.config import enable_compile_cache
from lanczosplusplus_tpu.io_.input_parser import read_input
from lanczosplusplus_tpu.io_.input_check import validate_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.solver import lanczos as lz


def run(argv=None):
    p = argparse.ArgumentParser(prog="consistency++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("--tinf", action="store_true",
                   help="also print the T=infinity mean energy")
    args = p.parse_args(argv)
    enable_compile_cache()
    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    basis = model.create_basis(model.default_parts(inp))
    ham = model.hamiltonian(basis)
    evals, _ = lz.lowest_states(ham, num_states=1)
    print(f"Lanczos: lowest eigenvalue= {evals[0]}")
    if ham.dim <= 20000:
        dense = np.linalg.eigvalsh(ham.to_dense())
        print(f"Lapack: lowest eigenvalue= {dense[0]}")
        diff = abs(dense[0] - evals[0])
        print(f"|difference|= {diff}")
        if args.tinf:
            print(f"T=infinity energy= {dense.mean()}")
    elif args.tinf:
        # trace/dim without full diagonalization
        tinf = float(np.asarray(ham.diag).mean())
        print(f"T=infinity energy= {tinf}")
    return evals[0]


def main():
    run()


if __name__ == "__main__":
    main()
