"""Factored-Kitaev matvec benchmark: n-site Kitaev chain over the full
2^n space as half-cut Kronecker GEMMs.

At n=24 the state is a (4096, 4096) matrix; the flat ELL for the same
Hamiltonian would need ~2^24 * slots gathered reads per matvec — the
factored form replaces that with two dense half-exchange GEMMs + a few
cross-bond GEMM pairs.

Usage: python benchmarks/kitaev_factored_bench.py [nsite]
(JAX_PLATFORMS=cpu pins the CPU backend.)
"""

import json
import os
import sys
import time

import numpy as np
import jax

import jax.numpy as jnp


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), ".."))
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.kitaev_factored import \
        build_factored_kitaev
    from lanczosplusplus_tpu.solver.lanczos import lowest_states_plain

    platform = jax.devices()[0].platform
    n = int(sys.argv[1]) if len(sys.argv) > 1 else \
        (24 if platform != "cpu" else 16)
    per = "\n".join(
        "DegreesOfFreedom=1\nGeometryKind=chain\n"
        f"GeometryOptions=ConstantValues\nConnectors 1 {j}"
        for j in (1.1, 0.7, 0.9))
    inp = parse_input(f"TotalNumberOfSites={n}\nNumberOfTerms=3\n"
                      f"{per}\nModel=Kitaev\nSolverOptions=factored\n")
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis(None)
    key = jax.random.PRNGKey(0)
    mv = jax.jit(lambda h, x: h.matvec(x))
    ham32 = None
    for fdt, tag in ((None, "f32"), (jnp.bfloat16, "bf16_factors")):
        ham = build_factored_kitaev(model, basis, dtype=np.float32,
                                    factor_dtype=fdt)
        if fdt is None:
            ham32 = ham
        dim = ham.dim
        x = jax.random.normal(key, (dim,), jnp.float32)
        x = x / jnp.linalg.norm(x)
        y = mv(ham, x)
        jax.block_until_ready(y)
        _ = float(y[0])
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            x = mv(ham, x)
        jax.block_until_ready(x)
        _ = float(x[0])
        dt = (time.perf_counter() - t0) / iters
        dl = ham.diag2d.shape[0]
        dr = ham.diag2d.shape[1]
        flops = 2 * dim * (dl + dr) + \
            2 * dim * (dl + dr) * ham.p.shape[0] // 2
        print(json.dumps({
            "metric": f"kitaev_factored_matvec_ms_{tag}",
            "value": round(dt * 1e3, 2),
            "unit": "ms", "detail": {
                "platform": platform, "nsite": n, "dim": dim,
                "cross_terms": int(ham.p.shape[0]),
                "tflops_per_s": round(flops / dt / 1e12, 1)}}))
    dim = ham32.dim

    t0 = time.perf_counter()
    evals, _ = lowest_states_plain(ham32, num_states=1, seed=7,
                                   max_steps=120)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "kitaev_factored_ground_state_s",
        "value": round(dt, 1), "unit": "s",
        "detail": {"nsite": n, "dim": dim, "e0": float(evals[0])}}))


if __name__ == "__main__":
    main()
