"""Flagship thermal demo: FTLM <E>(beta) over the FULL 2^24 Kitaev
chain (dim 16 777 216) using the block-factorized Hamiltonian.

The reference's thermal path (ed/ExactDiag) is O(dim^3) dense — at
this dimension it would need ~1e22 FLOPs and 2 PB; here the batched
FTLM recurrence runs R random vectors through M plain-Lanczos steps of
half-cut Kronecker GEMMs.

Usage: python benchmarks/kitaev_ftlm_demo.py [nsite] [R] [M]
"""

import json
import os
import sys
import time

import numpy as np
import jax


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.kitaev_factored import \
        build_factored_kitaev
    from lanczosplusplus_tpu.engine.ftlm import ftlm

    platform = jax.devices()[0].platform
    n = int(sys.argv[1]) if len(sys.argv) > 1 else \
        (24 if platform != "cpu" else 14)
    R = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    M = int(sys.argv[3]) if len(sys.argv) > 3 else 60
    per = "\n".join(
        "DegreesOfFreedom=1\nGeometryKind=chain\n"
        f"GeometryOptions=ConstantValues\nConnectors 1 {j}"
        for j in (1.1, 0.7, 0.9))
    inp = parse_input(f"TotalNumberOfSites={n}\nNumberOfTerms=3\n"
                      f"{per}\nModel=Kitaev\nSolverOptions=none\n")
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis(None)
    ham = build_factored_kitaev(model, basis, dtype=np.float32)

    betas = np.asarray([0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0])
    t0 = time.perf_counter()
    res = ftlm(ham, betas, num_vectors=R, steps=M, seed=20260818)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "kitaev_2p24_ftlm_energy_curve_s",
        "value": round(dt, 1), "unit": "s",
        "detail": {
            "platform": platform, "nsite": n, "dim": ham.dim,
            "R": R, "M": M,
            "beta": list(betas),
            "energy": [round(float(e), 4) for e in res.energy],
            "specific_heat": [round(float(c), 4)
                              for c in res.specific_heat],
            "entropy_per_site": [round(float(s) / n, 4)
                                 for s in res.entropy],
            "e0_estimate": round(res.e0_estimate, 6)}}))


if __name__ == "__main__":
    main()
