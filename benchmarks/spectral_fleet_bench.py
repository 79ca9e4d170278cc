"""Batched continued-fraction fleet vs serial per-pair Lanczos.

The DOS / S(q,omega) pipeline needs one plain tridiagonalization per
(site, operator-type) — the reference runs them serially
(LanczosDriver1.h:138-183 -> Engine.h:460-490).  Here all jobs landing
in the same destination sector run as ONE batched SpMM recurrence
(Engine.spectral_functions_batched -> tridiagonalize_plain_batched):
the Hamiltonian factors are read once per block step instead of once
per vector step, and each step is a batched GEMM.

Workload: 14-site half-filled Hubbard chain (sector dim 11.8M), DOS
fleet = 14 diagonal pairs x 2 types -> two (R=14, dim ~10.3M) batched
recurrences over the (8,7) and (6,7) sectors, SpectralSteps=64.

Run: python benchmarks/spectral_fleet_bench.py [--serial-too]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def main():
    import jax

    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.engine import Engine

    nsite = 14
    text = f"""
TotalNumberOfSites={nsite}
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU {nsite} {" ".join(["4"] * nsite)}
potentialV {2 * nsite} {" ".join(["0"] * 2 * nsite)}
SolverOptions=none
TargetElectronsUp={nsite // 2}
TargetElectronsDown={nsite // 2}
IsPeriodicX=1
LanczosSteps=120
SpectralSteps=64
"""
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    print(f"platform: {jax.devices()[0].platform}", file=sys.stderr)

    t0 = time.perf_counter()
    engine = Engine(model, inp)
    print(f"ground state ({engine.basis.size} dim): "
          f"E0={engine.ground_energy:.8f} "
          f"in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    pairs = [(i, i) for i in range(nsite)]

    # warm-up compile of the batched recurrence shapes (one per sector)
    t0 = time.perf_counter()
    outs = engine.spectral_functions_batched("c", pairs[:1], spin=0)
    print(f"single-pair batched (compile R=1): "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    outs = engine.spectral_functions_batched("c", pairs, spin=0)
    dt_batched_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = engine.spectral_functions_batched("c", pairs, spin=0)
    dt_batched = time.perf_counter() - t0
    njobs = sum(len(coll.items) for coll, _ in outs)
    print(f"batched fleet: {njobs} CFs ({len(pairs)} pairs x 2 types), "
          f"64 steps: {dt_batched:.2f}s warm ({dt_batched_cold:.2f}s "
          f"incl. compile) -> {dt_batched / njobs * 1e3:.0f} ms/CF",
          flush=True)

    if "--serial-too" in sys.argv:
        # serial reference schedule: one plain Lanczos per (pair, type)
        t0 = time.perf_counter()
        for (i, j) in pairs:
            engine.spectral_function("c", i, j, spin=0)
        dt_serial = time.perf_counter() - t0
        print(f"serial fleet (reference schedule): {dt_serial:.2f}s "
              f"-> {dt_serial / njobs * 1e3:.0f} ms/CF; "
              f"speedup {dt_serial / dt_batched:.2f}x", flush=True)

    # sanity: DOS sum rule on one site
    omegas = np.linspace(-10, 10, 201)
    g = outs[0][0].evaluate(omegas, 0.1)
    w = np.trapezoid(-g.imag / np.pi, omegas)
    print(f"site-0 DOS integral (sum rule ~1): {w:.4f}", flush=True)


if __name__ == "__main__":
    main()
