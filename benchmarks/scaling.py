"""Row-partition scaling harness (BASELINE.json configs: 1 chip /
1 host / >= 2 hosts).

This measures the distributed Lanczos step on a virtual CPU mesh to
validate the sharding and the collective structure (functional
scaling); on four NVLink-connected GPUs the same code path runs with
NCCL collectives.

Usage: JAX_PLATFORMS=cpu PYTHONPATH= \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python benchmarks/scaling.py
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


def main():
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.parallel import mesh as pmesh
    from lanczosplusplus_tpu.solver.lanczos import _lanczos_chunk

    nsite = 12
    text = f"""
TotalNumberOfSites={nsite}
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=ladder
GeometryOptions=ConstantValues
LadderLeg=2
Connectors 2 -1.0 -0.6
Model=HubbardOneBand
hubbardU {nsite} {" ".join(["4"] * nsite)}
potentialV {2 * nsite} {" ".join(["0"] * 2 * nsite)}
SolverOptions=none
TargetElectronsUp={nsite // 2}
TargetElectronsDown={nsite // 2}
IsPeriodicX=0
"""
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((nsite // 2, nsite // 2))
    ham = model.hamiltonian(basis, dtype=np.float32)
    print(f"dim={basis.size} nnz={ham.nnz}")

    def time_path(sham, mesh):
        dim = sham.dim
        steps = 16
        V = jax.device_put(
            jnp.zeros((steps, dim), jnp.float32),
            jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec(None, pmesh.ROWS)))
        v = pmesh.sharded_vector(
            jnp.ones((dim,), jnp.float32) / np.sqrt(dim), mesh)
        V, v2, a, b = _lanczos_chunk(sham, V, v, jnp.arange(8))
        jax.block_until_ready(b)
        t0 = time.perf_counter()
        V, v2, a, b = _lanczos_chunk(sham, V, v2, jnp.arange(8, 16))
        jax.block_until_ready(b)
        return (time.perf_counter() - t0) / 8

    from lanczosplusplus_tpu.parallel.kron import shard_kron_hamiltonian
    from lanczosplusplus_tpu.parallel.halo import KronHaloPlan

    results = {}
    for ndev in (1, 2, 4, 8):
        if ndev > len(jax.devices()):
            continue
        mesh = pmesh.make_mesh(jax.devices()[:ndev])
        dt_flat = time_path(pmesh.shard_hamiltonian(ham, mesh), mesh)
        kham, _ = shard_kron_hamiltonian(ham, mesh)
        dt_kron = time_path(kham, mesh)
        plan = KronHaloPlan(ham, ndev)
        dt_halo = time_path(plan.hamiltonian(mesh), mesh)
        results[ndev] = (dt_flat, dt_kron, dt_halo)
        base_f, base_k, base_h = results.get(
            1, (dt_flat, dt_kron, dt_halo))
        print(json.dumps({
            "devices": ndev,
            "flat_ell_s_per_iter": round(dt_flat, 4),
            "kron_s_per_iter": round(dt_kron, 4),
            "halo_s_per_iter": round(dt_halo, 4),
            "halo_fraction": round(plan.halo_fraction, 4),
            "kron_over_flat_x": round(dt_flat / dt_kron, 2),
            "flat_speedup_vs_1": round(base_f / dt_flat, 2),
            "kron_speedup_vs_1": round(base_k / dt_kron, 2),
            "halo_speedup_vs_1": round(base_h / dt_halo, 2),
        }))


if __name__ == "__main__":
    main()
