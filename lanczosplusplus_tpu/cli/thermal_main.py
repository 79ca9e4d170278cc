"""The `thermal` driver: grand-canonical averages + correlator poles.

Replaces the reference's dumpmatrix -> grandCanonical.pl -> thermal
pipeline (reference: src/thermal.cpp:232-314 CLI: -f file -c operator
-b beta -s site1[,site2] [-m mu] [-C constant]) with an in-process
sector sweep: the input file defines the model; all (nup, ndown)
sectors are full-diagonalized directly.
"""

from __future__ import annotations

import argparse
import sys

from lanczosplusplus_tpu.config import enable_compile_cache
from lanczosplusplus_tpu.io_.input_parser import read_input
from lanczosplusplus_tpu.io_.input_check import validate_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine.thermal import GrandCanonical


def run(argv=None):
    p = argparse.ArgumentParser(prog="thermal++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-c", dest="operator", default="i",
                   help="operator name or 'i' for Z/density/energy only")
    p.add_argument("-b", dest="beta", type=float, required=True)
    p.add_argument("-s", dest="sites", default="0",
                   help="site1[,site2]")
    p.add_argument("-m", dest="mu", type=float, default=0.0)
    p.add_argument("-C", dest="constant", type=float, default=0.0)
    p.add_argument("--spin", type=int, default=0)
    p.add_argument("--ftlm", action="store_true",
                   help="estimate the sector sweep by FTLM (per-sector "
                        "stochastic ln Z and <E>) instead of full "
                        "spectra — reaches sectors dense eigh cannot; "
                        "Z/density/energy only (correlator poles need "
                        "the full spectra)")
    args = p.parse_args(argv)
    enable_compile_cache()

    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    name = inp.string("Model")
    kind = {"TjMultiOrb": "tj", "Heisenberg": "heisenberg"}.get(
        name, "hubbard")
    if args.ftlm:
        if args.operator != "i":
            p.error("--ftlm supports Z/density/energy only "
                    "(correlator poles need the full spectra)")
        from lanczosplusplus_tpu.engine.thermal import GrandCanonicalFTLM
        gf = GrandCanonicalFTLM(
            model, geometry.number_of_sites(), [args.beta], kind=kind,
            num_vectors=inp.integer("FTLMVectors", default=16),
            steps=inp.integer("FTLMSteps", default=60),
            factored="factored" in inp.solver_options())
        lnz = gf.log_partition(args.beta, args.mu, args.constant)
        print(f"density={gf.density(args.beta, args.mu, args.constant)}"
              f" lnZPartition={lnz}", file=sys.stderr)
        print(f"energy={gf.energy(args.beta, args.mu, args.constant)}"
              f" lnZPartition={lnz}", file=sys.stderr)
        print(f"cv={gf.specific_heat(args.beta, args.mu, args.constant)}"
              f" lnZPartition={lnz}", file=sys.stderr)
        return gf
    gc = GrandCanonical(model, geometry.number_of_sites(), kind=kind)
    z = gc.partition(args.beta, args.mu, args.constant)
    print(f"density={gc.density(args.beta, args.mu, args.constant)} "
          f"zPartition={z}", file=sys.stderr)
    print(f"energy={gc.energy(args.beta, args.mu, args.constant)} "
          f"zPartition={z}", file=sys.stderr)
    if args.operator != "i":
        sites = [int(x) for x in args.sites.split(",")]
        if len(sites) == 1:
            sites = [sites[0], sites[0]]
        poles, total = gc.correlation_poles(
            args.operator, tuple(sites), args.spin, args.beta, args.mu,
            args.constant)
        for om, w in poles:
            print(f"{om} {w}")
        print(f"operator={args.operator} beta={args.beta} mu={args.mu} "
              f"partition={z} sum={total}", file=sys.stderr)
    return gc


def main():
    run()


if __name__ == "__main__":
    main()
