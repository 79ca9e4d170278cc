"""Measure KPM moment throughput and FTLM batched-recurrence rate on
the flagship 14-site half-filled Hubbard sector (dim 11.8M).

Run on the GPU (default platform) or CPU (JAX_PLATFORMS=cpu).
Prints one JSON line per measurement.
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
    from bench import build_hamiltonian
    from lanczosplusplus_tpu.engine.kpm import _moment_recurrence
    from lanczosplusplus_tpu.engine.ftlm import _ftlm_recurrence

    platform = jax.devices()[0].platform
    nsite = 14 if platform != "cpu" else 10
    ham, basis = build_hamiltonian(nsite, dtype=np.float32)
    ham = ham.densify_factors()
    dim = ham.dim
    nnz = ham.nnz

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (1, dim), jnp.float32)
    x = x / jnp.linalg.norm(x)

    # A single scan timing conflates the fixed dispatch latency with
    # compute: measure TWO scan lengths and report the slope (per-step
    # marginal cost).
    def timed(fn, *args):
        out = fn(*args)
        jax.block_until_ready(out)
        leaf = jax.tree_util.tree_leaves(out)[0]
        _ = float(np.asarray(leaf).reshape(-1)[0])
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        leaf = jax.tree_util.tree_leaves(out)[0]
        _ = float(np.asarray(leaf).reshape(-1)[-1])
        return time.perf_counter() - t0

    # KPM: product-rule doubling -> one matvec per moment PAIR
    a = jnp.asarray(10.0, jnp.float32)
    b = jnp.asarray(0.0, jnp.float32)
    p1, p2 = 8, 40
    t1 = timed(lambda: _moment_recurrence(ham, x, a, b, p1))
    t2 = timed(lambda: _moment_recurrence(ham, x, a, b, p2))
    dt = max(t2 - t1, 1e-9) / (p2 - p1)
    print(json.dumps({
        "metric": "kpm_moments_per_s", "value": round(2.0 / dt, 1),
        "unit": "moments/s",
        "detail": {"platform": platform, "dim": dim, "nnz": nnz,
                   "ms_per_moment_pair": round(dt * 1e3, 3),
                   "launch_overhead_s": round(t1 - p1 * dt, 2),
                   "gnnz_per_s": round(nnz / dt / 1e9, 1)}}))

    # FTLM: batched plain recurrence over R random vectors
    for R in (4, 16):
        V0 = jax.random.normal(key, (R, dim), jnp.float32)
        V0 = V0 / jnp.linalg.norm(V0, axis=1, keepdims=True)
        Y = jnp.zeros((0, R, dim), jnp.float32)
        s1, s2 = 4, 20
        t1 = timed(lambda: _ftlm_recurrence(ham, V0, Y, s1))
        t2 = timed(lambda: _ftlm_recurrence(ham, V0, Y, s2))
        dt = max(t2 - t1, 1e-9) / (s2 - s1)
        print(json.dumps({
            "metric": f"ftlm_batched_steps_per_s_R{R}",
            "value": round(1.0 / dt, 2), "unit": "block-steps/s",
            "detail": {"platform": platform, "dim": dim, "R": R,
                       "ms_per_block_step": round(dt * 1e3, 2),
                       "vector_steps_per_s": round(R / dt, 1),
                       "gnnz_per_s": round(nnz * R / dt / 1e9, 1)}}))


if __name__ == "__main__":
    main()
