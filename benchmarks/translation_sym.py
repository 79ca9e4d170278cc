"""Translation/reflection symmetry at ~1e6-dim (VERDICT items r1-9, r2-6).

14-site Hubbard chain, (4, 4) sector: dim 1 002 001.  The
row-restricted block construction (symmetry/blocks.py) never
materializes the full-sector CSR; all symmetry blocks are built and
solved, and min_s E0(s) must equal the unsymmetrized sector ground
energy.  Default: periodic chain, 14 momentum blocks.  With
--reflection: open chain, the two parity blocks (~501k dim each).

Usage: PYTHONPATH=. python benchmarks/translation_sym.py [--reflection]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def kitaev_flagship(n: int):
    """Kitaev chain at 2^n with translation k-blocks built from the
    FACTORED half-cut's restricted representative rows (VERDICT r3 item
    9: no 2^n x K flat ELL is ever materialized).  Solves the k=0
    block and cross-checks E0 against the unsymmetrized factored solve.
    Measured on the throttled 2-vCPU round-4 box: 2^20 builds in ~18s,
    2^22 in ~71s (linear in dim)."""
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.kitaev_factored import \
        build_factored_kitaev
    from lanczosplusplus_tpu.symmetry import TranslationSymmetry
    from lanczosplusplus_tpu.solver import lanczos as lz

    term = ("DegreesOfFreedom=1\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nConnectors 1 {v}\n")
    text = (f"TotalNumberOfSites={n}\nNumberOfTerms=3\n"
            + term.format(v=1.1) + term.format(v=0.7)
            + term.format(v=0.9)
            + "Model=Kitaev\nSolverOptions=none\nIsPeriodicX=1\n")
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis(None)
    t0 = time.perf_counter()
    sym = TranslationSymmetry(basis, geom, model, fermionic=False)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    blk = sym.block_hamiltonian(0)
    t_block = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev, _ = lz.lowest_states(blk, max_steps=200)
    t_solve = time.perf_counter() - t0
    fac = build_factored_kitaev(model, basis, dtype=np.float64)
    e_fac, _ = lz.lowest_states(fac, max_steps=200)
    print(json.dumps({
        "symmetry": "translation", "model": "Kitaev",
        "dim": basis.size, "k0_dim": blk.dim,
        "e0_k0": float(ev[0]), "e0_factored": float(e_fac[0]),
        "match": bool(abs(float(ev[0]) - float(e_fac[0])) < 1e-8),
        "sym_build_s": round(t_build, 2),
        "k0_block_build_s": round(t_block, 2),
        "k0_solve_s": round(t_solve, 2)}))


def projected_flagship(n: int):
    """Momentum-projected Lanczos over the full 2^n Kitaev chain
    (symmetry/projected.py, SolverOptions=projected), runnable on the
    CPU to document equivalence at non-toy dims
    (per-k E0s, min-k vs unsymmetrized, winner purity)."""
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.kitaev_factored import \
        build_factored_kitaev
    from lanczosplusplus_tpu.symmetry.projected import \
        ProjectedTranslationSolver
    from lanczosplusplus_tpu.solver.lanczos import (
        tridiagonalize_plain, tridiag_eigh, lowest_states)

    term = ("DegreesOfFreedom=1\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nConnectors 1 {v}\n")
    text = (f"TotalNumberOfSites={n}\nNumberOfTerms=3\n"
            + term.format(v=1.1) + term.format(v=0.7)
            + term.format(v=0.9)
            + "Model=Kitaev\nSolverOptions=none\nIsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(None)
    t0 = time.perf_counter()
    fac = build_factored_kitaev(model, basis, dtype=np.float64)
    proj = ProjectedTranslationSolver(fac, n)
    t_build = time.perf_counter() - t0
    e_plain, _ = lowest_states(fac, max_steps=200)
    t0 = time.perf_counter()
    e_ks = []
    for s in range(proj.sectors()):
        pk = proj.projected(s)
        res = tridiagonalize_plain(pk, proj.start_vector(s), 160)
        ev, _ = tridiag_eigh(res.alphas, res.betas)
        e_ks.append(float(ev[0]))
    t_ks = time.perf_counter() - t0
    kwin = int(np.argmin(e_ks))
    e_win, v_win, _ = proj.solve_sector(kwin, max_steps=200)
    print(json.dumps({
        "symmetry": "translation-projected", "model": "Kitaev",
        "dim": basis.size, "sectors": proj.sectors(),
        "e0_per_k": [round(e, 9) for e in e_ks],
        "min_k": kwin,
        "e0_min_k": float(e_win[0]),
        "e0_plain": float(e_plain[0]),
        "match": bool(abs(float(e_win[0]) - float(e_plain[0]))
                      < 1e-7 * abs(float(e_plain[0]))),
        "winner_purity": round(proj.purity(kwin, v_win[0]), 10),
        "build_s": round(t_build, 2),
        "all_sectors_solve_s": round(t_ks, 2)}))


def main():
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.symmetry import (ReflectionSymmetry,
                                               TranslationSymmetry)
    from lanczosplusplus_tpu.solver import lanczos as lz

    if "--projected" in sys.argv:
        i = sys.argv.index("--projected")
        n = int(sys.argv[i + 1]) if len(sys.argv) > i + 1 else 18
        projected_flagship(n)
        return

    if "--kitaev" in sys.argv:
        i = sys.argv.index("--kitaev")
        n = int(sys.argv[i + 1]) if len(sys.argv) > i + 1 else 20
        kitaev_flagship(n)
        return

    reflection = "--reflection" in sys.argv
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
TargetElectronsUp=4
TargetElectronsDown=4
IsPeriodicX={0 if reflection else 1}
"""
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((4, 4))
    print(f"sector dim = {basis.size}")
    ham = model.hamiltonian(basis)
    t0 = time.perf_counter()
    e_plain, _ = lz.lowest_states(ham, max_steps=200)
    t_plain = time.perf_counter() - t0

    t0 = time.perf_counter()
    sym = (ReflectionSymmetry(basis, geom, model) if reflection
           else TranslationSymmetry(basis, geom, model))
    t_build = time.perf_counter() - t0
    best = None
    t0 = time.perf_counter()
    block_dims = []
    for s in range(sym.sectors()):
        blk = sym.block_hamiltonian(s)
        if blk is None:
            continue
        block_dims.append(blk.dim)
        ev, _ = lz.lowest_states(blk, max_steps=200)
        e = float(ev[0])
        best = e if best is None else min(best, e)
    t_blocks = time.perf_counter() - t0
    print(json.dumps({
        "symmetry": "reflection" if reflection else "translation",
        "dim": basis.size,
        "e0_plain": float(e_plain[0]),
        "e0_sym": best,
        "match": bool(abs(best - float(e_plain[0])) < 1e-7),
        "sym_build_s": round(t_build, 2),
        "blocks_total_solve_s": round(t_blocks, 2),
        "plain_solve_s": round(t_plain, 2),
        "block_dims": block_dims,
    }))


if __name__ == "__main__":
    main()
