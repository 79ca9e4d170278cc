"""Factored (block-Kronecker / half-cut) vs flat gather-ELL matvec on
the same sectors, on whatever device JAX picks.

Reports, per model: ms/matvec for both paths, the speedup, the true
nonzero count, and the slot rate of the flat path (the accounting the
round-1 53.9 Gnnz/s number used: every stored ELL slot, padding
included).

Usage: PYTHONPATH=. python benchmarks/factored_vs_flat.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp


def time_matvec(ham, iters=20):
    matvec = jax.jit(lambda h, x: h.matvec(x))
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (ham.dim,), jnp.float32)
    x = x / jnp.linalg.norm(x)
    y = matvec(ham, x)
    y.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        x = matvec(ham, x)
    x.block_until_ready()
    return (time.perf_counter() - t0) / iters


def tj_case(nsite=16):
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.tj_factored import build_factored_tj

    nup = ndn = nsite // 2 - 1
    term = """DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 {v}
"""
    text = (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + term.format(v=-1.0) + term.format(v=0.3)
            + term.format(v=0.3) + term.format(v=0.0)
            + f"Model=TjMultiOrb\nOrbitals=1\nSolverOptions=none\n"
              f"TargetElectronsUp={nup}\nTargetElectronsDown={ndn}\n"
              "IsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis((nup, ndn))
    flat = model.hamiltonian(basis, dtype=np.float32)
    fact = build_factored_tj(model, basis, dtype=np.float32)
    flat_slots = flat.dim * (1 + flat.ell.cols.shape[1])
    return "tj", basis.size, flat, fact, flat_slots


def tj2_case(nsite=8):
    """2-orbital t-J sector — the multi-orbital half-cut (VERDICT r2
    item 7): per-(site,orbital) bits, spatial cut unchanged."""
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.tj_factored import build_factored_tj

    nup = ndn = nsite // 2
    def term(d0, d1, off):
        return f"""DegreesOfFreedom=2
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 2 2
{d0} {off}
{off} {d1}
"""
    text = (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + term(-1.0, -0.8, 0.2) + term(0.4, 0.3, 0.1)
            + term(0.35, 0.3, 0.0) + term(0.0, 0.0, 0.0)
            + f"Model=TjMultiOrb\nOrbitals=2\nSolverOptions=none\n"
              f"TargetElectronsUp={nup}\nTargetElectronsDown={ndn}\n"
              "IsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis((nup, ndn))
    flat = model.hamiltonian(basis, dtype=np.float32)
    fact = build_factored_tj(model, basis, dtype=np.float32)
    flat_slots = flat.dim * (1 + flat.ell.cols.shape[1])
    return "tj_2orb", basis.size, flat, fact, flat_slots


def rashba_case(nsite=12):
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model

    term = """DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 {v}
"""
    text = (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n"
            + term.format(v=-1.0) + term.format(v=0.5)
            + "Model=HubbardOneBandRashbaSOC\n"
            + f"hubbardU {nsite} {' '.join(['4'] * nsite)}\n"
            + f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
            + "SolverOptions=none\n"
            + f"TargetElectronsTotal={nsite}\nIsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(("ne", nsite))
    from lanczosplusplus_tpu.models.rashba_halfcut import \
        build_halfcut_rashba
    flat = model.hamiltonian(basis, dtype=np.float32)
    fact = build_halfcut_rashba(model, basis, dtype=np.float32).inner
    flat_slots = flat.dim * (1 + flat.ell.cols.shape[1])
    return "rashba", basis.size, flat, fact, flat_slots


def main():
    import gc

    print(json.dumps({"platform": jax.devices()[0].platform}),
          flush=True)

    for case in (tj_case, tj2_case, rashba_case):
        name, dim, flat, fact, flat_slots = case()
        dt_flat = time_matvec(flat)
        del flat
        gc.collect()
        dt_fact = time_matvec(fact)
        nnz = fact.nnz
        del fact
        gc.collect()
        print(json.dumps({
            "model": name, "dim": dim,
            "flat_ms": round(dt_flat * 1e3, 3),
            "factored_ms": round(dt_fact * 1e3, 3),
            "speedup_x": round(dt_flat / dt_fact, 2),
            "true_nnz": int(nnz),
            "factored_true_gnnz_per_s":
                round(nnz / dt_fact / 1e9, 1),
            "flat_slot_gnnz_per_s":
                round(flat_slots / dt_flat / 1e9, 1),
            "factored_slotequiv_gnnz_per_s":
                round(flat_slots / dt_fact / 1e9, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
