"""quasiparticleWeightZ driver (reference: src/quasiparticleWeightZ.cpp):
Z(k) = |<gs_{N-1}| c_k |gs_N>|^2 for all momenta."""

from __future__ import annotations

import argparse

from lanczosplusplus_tpu.config import enable_compile_cache
from lanczosplusplus_tpu.io_.input_parser import read_input
from lanczosplusplus_tpu.io_.input_check import validate_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine import Engine
from lanczosplusplus_tpu.engine.dynamics import quasiparticle_weight_z


def run(argv=None):
    p = argparse.ArgumentParser(prog="quasiparticleWeightZ++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("--spin", type=int, default=0)
    p.add_argument("--ratio", action="store_true",
                   help="normalize by <phi_k|phi_k>")
    args = p.parse_args(argv)
    enable_compile_cache()
    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    engine = Engine(model, inp)
    out = quasiparticle_weight_z(engine, spin=args.spin,
                                 ratio=args.ratio)
    for k, z in out:
        print(f"{k} {z}")
    return out


def main():
    run()


if __name__ == "__main__":
    main()
