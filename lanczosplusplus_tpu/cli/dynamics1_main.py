"""dynamics1 driver (reference: src/dynamics1.cpp): continued fraction
of |phi> = sum_site e^{ik site} (c^dag_{a,up} c_{b,up})_site |gs>,
written with the SPECTRAL tag."""

from __future__ import annotations

import argparse
import sys

from lanczosplusplus_tpu.config import enable_compile_cache
from lanczosplusplus_tpu.io_.input_parser import read_input
from lanczosplusplus_tpu.io_.input_check import validate_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine import Engine
from lanczosplusplus_tpu.engine.dynamics import dynamics1_spectral
from lanczosplusplus_tpu.engine.spectral import \
    ContinuedFractionCollection


def run(argv=None):
    p = argparse.ArgumentParser(prog="dynamics1++")
    p.add_argument("-f", dest="input", required=True)
    p.add_argument("-r", dest="m_for_k", type=int, default=0,
                   help="momentum index (reference reuses -r)")
    p.add_argument("--orbs", default="0,1")
    args = p.parse_args(argv)
    enable_compile_cache()
    inp = read_input(args.input)
    validate_input(inp)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    engine = Engine(model, inp)
    print(f"Energy={engine.ground_energy:.8g}")
    orbs = tuple(int(x) for x in args.orbs.split(","))
    cf = dynamics1_spectral(engine, args.m_for_k, orbs=orbs)
    coll = ContinuedFractionCollection([cf])
    coll.write(sys.stdout, index_to_cf=["SPECTRAL"])
    return cf


def main():
    run()


if __name__ == "__main__":
    main()
