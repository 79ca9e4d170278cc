"""The `ed` driver: full diagonalization + <E>(T or beta) schedule
(reference: src/ed.cpp)."""

from __future__ import annotations

import argparse
import sys

from lanczosplusplus_tpu.config import enable_compile_cache
from lanczosplusplus_tpu.io_.input_parser import read_input
from lanczosplusplus_tpu.io_.input_check import validate_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine.thermal import ExactDiag


def run(argv=None):
    p = argparse.ArgumentParser(prog="ed++")
    p.add_argument("-f", dest="input", required=True)
    est = p.add_mutually_exclusive_group()
    est.add_argument("--ftlm", action="store_true",
                     help="estimate <E>(T) by the finite-temperature "
                          "Lanczos method instead of the full spectrum "
                          "(scales to sectors dense eigh cannot touch)")
    est.add_argument("--ltlm", action="store_true",
                     help="estimate <E>(T) by the low-temperature "
                          "Lanczos method (symmetric estimator: the "
                          "beta -> inf tail is exact, where plain FTLM "
                          "is noisy)")
    args = p.parse_args(argv)
    enable_compile_cache()
    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    use_ltlm = args.ltlm or "ltlm" in inp.solver_options()
    use_ftlm = args.ftlm or "ftlm" in inp.solver_options()
    if use_ltlm:
        from lanczosplusplus_tpu.engine.ftlm import ltlm_schedule
        schedule, res = ltlm_schedule(
            model, inp,
            num_vectors=inp.integer("FTLMVectors", default=16),
            steps=inp.integer("FTLMSteps", default=80))
        sys.stdout.write(
            f"#tb={inp.string('TemperatureOrBeta', default='temperature')}"
            " method=LTLM\n#Parameter Energy\n")
        for tb, e in schedule:
            sys.stdout.write(f"{tb} {e}\n")
        return res
    if use_ftlm:
        from lanczosplusplus_tpu.engine.ftlm import ftlm_schedule
        schedule, res = ftlm_schedule(
            model, inp,
            num_vectors=inp.integer("FTLMVectors", default=32),
            steps=inp.integer("FTLMSteps", default=80))
        sys.stdout.write(
            f"#tb={inp.string('TemperatureOrBeta', default='temperature')}"
            f" method=FTLM R={res.num_vectors} M={res.steps}\n"
            "#Parameter Energy\n")
        for tb, e in schedule:
            sys.stdout.write(f"{tb} {e}\n")
        return res
    ed = ExactDiag(model, inp)
    ed.print_energies(sys.stdout)
    return ed


def main():
    run()


if __name__ == "__main__":
    main()
