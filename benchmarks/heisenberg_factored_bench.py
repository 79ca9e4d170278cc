"""Large-chain S=1/2 Heisenberg via the block-factorized solver.

24-site PBC chain, Sz=0 sector: dim C(24,12) = 2,704,156.  The flat ELL
would store ~dim*49 column indices; the factored form stores only
half-chain matrices (max 924x924) and runs the whole matvec as dense
matmuls.  Usage: python benchmarks/heisenberg_factored_bench.py [nsite]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models.heisenberg import HeisenbergModel
from lanczosplusplus_tpu.models.heisenberg_factored import \
    FactoredHeisenbergChain
from lanczosplusplus_tpu.solver.lanczos import lowest_states


def main():
    nsite = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    inp = parse_input(f"""
TotalNumberOfSites={nsite}
NumberOfTerms=2
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 1.0
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 1.0
Model=Heisenberg
HeisenbergTwiceS=1
SolverOptions=none
TargetSzPlusConst={nsite // 2}
IsPeriodicX=1
""")
    model = HeisenbergModel(inp, Geometry(inp))
    t0 = time.time()
    fact = FactoredHeisenbergChain(model, nsite, nsite // 2,
                                   dtype=np.float32)
    print(f"build: {time.time() - t0:.2f}s  dim={fact.ham.dim} "
          f"blocks={len(fact.ham.shapes)} "
          f"largest={max(a * b for a, b in fact.ham.shapes)}")

    mv = jax.jit(fact.ham.matvec)
    x = jnp.ones(fact.ham.dim, np.float32) / np.sqrt(fact.ham.dim)
    y = mv(x)
    float(y[0])
    t0 = time.time()
    iters = 20
    for _ in range(iters):
        y = mv(y)
    float(y[0])
    ms = (time.time() - t0) / iters * 1e3
    print(f"matvec: {ms:.2f} ms  platform={jax.devices()[0].platform}")

    t0 = time.time()
    evals, _ = lowest_states(fact.ham, num_states=1, max_steps=300,
                             tol=1e-8)
    dt = time.time() - t0
    e0 = float(evals[0])
    print(f"E0 = {e0:.10f}  ({dt:.1f}s)")
    print(f"E0/site = {e0 / nsite:.10f}  "
          f"(Bethe thermodynamic limit: {0.25 - np.log(2):.10f})")


if __name__ == "__main__":
    main()
