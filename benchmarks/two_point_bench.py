"""two_point batched-GEMM path vs the reference-shaped host loop


C(i,j) = <gs| c^dag_j c_i |gs> over all site pairs of a half-filled
Hubbard chain: the production path builds every modified state in one
device scatter and evaluates the whole pair matrix as a single GEMM;
the comparison loop reproduces round 1's implementation (per-site host
scatters + n^2 host vdots — itself already the vectorized analogue of
the reference's per-pair loops, Engine.h:266-338).

Usage: PYTHONPATH=. python benchmarks/two_point_bench.py [nsite]
(JAX_PLATFORMS=cpu runs it in float64 on the CPU; otherwise it runs
on the default device.)
"""

import os
import sys
import time
import json

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import jax

if jax.default_backend() == "cpu":
    jax.config.update("jax_enable_x64", True)

import numpy as np


def main():
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.engine import Engine
    from lanczosplusplus_tpu.engine.engine import apply_operator_map
    from lanczosplusplus_tpu.engine.operators import LabeledOperator

    nsite = int(sys.argv[1]) if len(sys.argv) > 1 else 12
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
"""
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    eng = Engine(model, inp)
    op = LabeledOperator("c")
    new_parts = model.has_new_parts(eng.parts, op, 0, 0)
    basis_new = eng._cached_basis(new_parts)
    print(f"sector dim {eng.basis.size} -> destination {basis_new.size}")

    t0 = time.perf_counter()
    c_fast = eng.two_point("c")
    t_fast = time.perf_counter() - t0
    # second call reuses the engine's operator-map cache: isolates the
    # scatter + GEMM stage (the stage the reference's pair loop pays
    # n^2 times)
    t0 = time.perf_counter()
    c_fast = eng.two_point("c")
    t_fast_cached = time.perf_counter() - t0

    # round-1 path: host scatters + n^2 host vdots.  At large dims the
    # full loop takes many minutes on this host; time a column subset
    # and extrapolate (each pair's vdot costs the same).
    gs = np.asarray(eng.eigenvector(0))
    t0 = time.perf_counter()
    mods = []
    for isite in range(nsite):
        tgt, amp, dst_dim = model.operator_map(op, isite, 0, 0,
                                               eng.basis, basis_new)
        mods.append(apply_operator_map(tgt, amp, dst_dim, gs, 1.0))
    t_scatter = time.perf_counter() - t0
    jcols = range(nsite) if basis_new.size < (1 << 21) else range(2)
    c_slow = np.full((nsite, nsite), np.nan, dtype=np.complex128)
    t0 = time.perf_counter()
    npairs = 0
    for j in jcols:
        for i in range(nsite):
            c_slow[i, j] = np.vdot(mods[j], mods[i])
            npairs += 1
    t_vdots = (time.perf_counter() - t0) * (nsite * nsite) / npairs
    t_slow = t_scatter + t_vdots

    err = np.nanmax(np.abs(c_fast - c_slow)[:, list(jcols)])
    print(json.dumps({
        "nsite": nsite,
        "batched_gemm_s": round(t_fast, 3),
        "batched_gemm_cached_maps_s": round(t_fast_cached, 3),
        "host_loop_s": round(t_slow, 3),
        "host_vdots_only_s": round(t_vdots, 3),
        "host_loop_extrapolated": npairs != nsite * nsite,
        "speedup_x": round(t_slow / t_fast, 1),
        "speedup_cached_x": round(t_slow / t_fast_cached, 1),
        "pair_stage_speedup_x": round(t_vdots / t_fast_cached, 1),
        "max_abs_diff": float(f"{err:.3g}"),
    }))


if __name__ == "__main__":
    main()
