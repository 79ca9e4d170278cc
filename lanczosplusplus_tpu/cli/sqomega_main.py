"""S(q, omega) / N(i, omega) driver (replaces scripts/sqomega.pl and
scripts/niomega.pl; runs the whole pipeline in-process)."""

from __future__ import annotations

import argparse

import numpy as np

from lanczosplusplus_tpu.config import enable_compile_cache
from lanczosplusplus_tpu.io_.input_parser import read_input
from lanczosplusplus_tpu.io_.input_check import validate_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine import Engine
from lanczosplusplus_tpu import postproc


def run(argv=None):
    p = argparse.ArgumentParser(prog="sqomega++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-g", dest="observable", default="sz")
    p.add_argument("-b", dest="wbegin", type=float, required=True)
    p.add_argument("-e", dest="wend", type=float, required=True)
    p.add_argument("-s", dest="wstep", type=float, required=True)
    p.add_argument("-d", dest="wdelta", type=float, required=True)
    p.add_argument("--spin", type=int, default=0)
    p.add_argument("--dos", action="store_true",
                   help="N(i, omega) per site instead of S(q, omega)")
    p.add_argument("--beta", type=float, default=None,
                   help="FINITE-temperature S(q, omega) at this "
                        "inverse temperature via the FTLM "
                        "double-Krylov estimator (sector-preserving "
                        "observables; labels FTLMVectors/FTLMSteps)")
    args = p.parse_args(argv)
    enable_compile_cache()

    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    engine = Engine(model, inp)
    omegas = np.arange(args.wbegin, args.wend + 1e-12, args.wstep)
    if args.beta is not None:
        qs, sqw = engine.ftlm_sq_omega(
            args.observable, args.beta, omegas, delta=args.wdelta,
            spin=args.spin,
            num_vectors=inp.integer("FTLMVectors", default=16),
            steps=inp.integer("FTLMSteps", default=100))
        print(f"#beta={args.beta} method=FTLM")
        for wi, w in enumerate(omegas):
            print(w, " ".join(f"{sqw[m, wi]:.8g}"
                              for m in range(len(qs))))
        return qs, sqw
    if args.dos:
        dos = postproc.ni_omega(engine, omegas, args.wdelta,
                                spin=args.spin)
        for wi, w in enumerate(omegas):
            print(w, " ".join(f"{dos[i, wi]:.8g}"
                              for i in range(dos.shape[0])))
        return dos
    qs, sqw = postproc.sq_omega(engine, args.observable, omegas,
                                args.wdelta, spin=args.spin)
    intensity = -sqw.imag / np.pi
    for wi, w in enumerate(omegas):
        print(w, " ".join(f"{intensity[m, wi]:.8g}"
                          for m in range(len(qs))))
    return qs, sqw


def main():
    run()


if __name__ == "__main__":
    main()
