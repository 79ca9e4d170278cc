"""On-chip correctness section of bench.py and chip_smoke.py.

The full test suite runs on CPU in float64 (tests/conftest.py); the
production device path is f32 (+df64/RQI refinement).  This module runs
REAL observable pipelines — sector ground energies of the three
reference TestSuite inputs, a continued-fraction G(omega) on a t-J
chain, a two-point correlator row, an FTLM thermal point — through the
production engine at the ambient (chip) dtype and compares against
goldens computed ONCE on CPU float64 by INDEPENDENT oracles (dense
eigh Lehmann sums, scipy eigsh over the host-f64 matvec; the FTLM
golden is the same estimator at f64 with the same seed, so its error
field isolates chip-dtype deviation, not stochastic error).

Goldens live in benchmarks/goldens.json; regenerate on CPU with

    JAX_PLATFORMS=cpu python benchmarks/onchip_correctness.py --write

The reference's correctness bar is S(q,omega)/G(omega) agreement on
the TestSuite inputs (BASELINE.json north_star; inputs mirrored from
the reference TestSuite inputs input{0,10,100}.inp, transcribed in
tests/data).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

GOLDENS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "goldens.json")

INPUT0 = """
TotalNumberOfSites=4
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU 4 0 0 0 0
potentialV 8 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=2
TargetElectronsDown=2
IsPeriodicX=0
"""

INPUT10 = """
TotalNumberOfSites=4
NumberOfTerms=2
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 7.0
Model=HubbardOneBandRashbaSOC
hubbardU 4 0 0 0 0
potentialV 8 0 0 0 0 0 0 0 0
SolverOptions=useComplex
TargetElectronsTotal=1
IsPeriodicX=0
"""

INPUT100 = """
TotalNumberOfSites=6
Model=FeAsBasedSc
FeAsMode=INT_PAPER33
NumberOfTerms=1
DegreesOfFreedom=2
Orbitals=2
GeometryKind=chain
GeometryOptions=ConstantValues
SolverOptions=useComplex
hubbardU 4 4.0 3.0 -0.8 -0.4
Connectors 2 2
-1.0 0.0
0.0 -1.0
potentialV 24
4.10 4.10 4.10 4.10 4.10 4.10
0.0 0.0 0.0 0.0 0.0 0.0
4.10 4.10 4.10 4.10 4.10 4.10
0.0 0.0 0.0 0.0 0.0 0.0
TargetElectronsUp=3
TargetElectronsDown=3
"""

# input104 = input100 + AnisotropyD (the -AnisotropyD FeAs TestSuite
# config, input104.inp)
INPUT104 = INPUT100.replace(
    "TargetElectronsDown=3\n",
    "TargetElectronsDown=3\nAnisotropyD=7\n")

TJ8 = """
TotalNumberOfSites=8
NumberOfTerms=4
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 0.3
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 0.3
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 0.0
Model=TjMultiOrb
Orbitals=1
SolverOptions=none
TargetElectronsUp=3
TargetElectronsDown=3
IsPeriodicX=1
"""

HUB10 = """
TotalNumberOfSites=10
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU 10 4 4 4 4 4 4 4 4 4 4
potentialV 20 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=2
TargetElectronsDown=2
IsPeriodicX=1
"""

OMEGAS = np.linspace(-6.0, 8.0, 57)
DELTA = 0.25
FTLM_BETA = [0.5, 2.0]
FTLM_SEED = 424243
FTLM_VECTORS = 24
FTLM_STEPS = 40


def _model(text):
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model

    inp = parse_input(text)
    return inp, build_model(inp, Geometry(inp))


def _lehmann_cf(model, parts, isite, spin):
    """Independent oracle: G_ii(omega) from dense spectra of the three
    sectors via operator_matrix (model-agnostic; reference Lehmann
    convention of Engine.h:133-206's 4-type decomposition)."""
    from lanczosplusplus_tpu.engine.thermal import operator_matrix

    basis0 = model.create_basis(parts)
    h0 = np.asarray(model.hamiltonian(basis0,
                                      dtype=np.float64).to_dense())
    e0s, v0s = np.linalg.eigh(h0)
    gs = v0s[:, 0]
    e0 = e0s[0]
    z = OMEGAS + 1j * DELTA
    total = np.zeros_like(z, dtype=np.complex128)
    from lanczosplusplus_tpu.engine.operators import LabeledOperator

    op = LabeledOperator("c")
    # particle part: c^dagger into the larger sector
    dst_parts = model.has_new_parts(parts, op.transpose_conjugate(),
                                    spin, 0)
    if dst_parts is not None:
        bas = model.create_basis(dst_parts)
        h = np.asarray(model.hamiltonian(bas,
                                         dtype=np.float64).to_dense())
        es, vs = np.linalg.eigh(h)
        a = operator_matrix(model, "cdagger", isite, spin, 0,
                            basis0, bas)
        amp = vs.T @ (a.T @ gs)
        for n in range(len(es)):
            total += amp[n] ** 2 / (z - (es[n] - e0))
    # hole part: c into the smaller sector
    dst_parts = model.has_new_parts(parts, op, spin, 0)
    if dst_parts is not None:
        bas = model.create_basis(dst_parts)
        if bas.size:
            h = np.asarray(model.hamiltonian(
                bas, dtype=np.float64).to_dense())
            es, vs = np.linalg.eigh(h)
            a = operator_matrix(model, "c", isite, spin, 0, basis0, bas)
            amp = vs.T @ (a.T @ gs)
            for m in range(len(es)):
                total += amp[m] ** 2 / (z + (es[m] - e0))
    return total


def compute_goldens():
    """All goldens on CPU float64.  Independent oracles except the FTLM
    entry (same estimator at f64, same seed — see module docstring)."""
    import scipy.sparse.linalg as spla

    from lanczosplusplus_tpu.engine.thermal import operator_matrix
    from lanczosplusplus_tpu.engine.ftlm import ftlm
    from lanczosplusplus_tpu.ops.df64 import host_matvec_f64

    g = {}
    # -- input0 E0 (dense oracle)
    inp0, m0 = _model(INPUT0)
    b0 = m0.create_basis((2, 2))
    h0 = np.asarray(m0.hamiltonian(b0, dtype=np.float64).to_dense())
    e0s, v0s = np.linalg.eigh(h0)
    g["e0_input0"] = float(e0s[0])
    # two-point row <gs|c^dag_0,up c_j,up|gs> from the dense gs
    gs = v0s[:, 0]
    bm = m0.create_basis((1, 2))
    cs = [operator_matrix(m0, "c", j, 0, 0, b0, bm) for j in range(4)]
    row = [float((cs[0] @ (cs[j].T @ gs)) @ gs) for j in range(4)]
    g["two_point_row_input0"] = row

    # -- input10 E0 (dense oracle, complex Rashba)
    inp10, m10 = _model(INPUT10)
    b10 = m10.create_basis(m10.default_parts(inp10))
    h10 = np.asarray(m10.hamiltonian(b10,
                                     dtype=np.complex128).to_dense())
    g["e0_input10"] = float(np.linalg.eigvalsh(h10)[0])

    # -- input100 E0 (scipy eigsh over the independent host-f64 matvec)
    inp100, m100 = _model(INPUT100)
    b100 = m100.create_basis((3, 3))
    h100 = m100.hamiltonian(b100, dtype=np.complex128)
    op = spla.LinearOperator(
        (h100.dim, h100.dim),
        matvec=lambda v: host_matvec_f64(h100, v),
        dtype=np.complex128)
    g["e0_input100"] = float(spla.eigsh(
        op, k=1, which="SA", return_eigenvectors=False, tol=1e-12)[0])
    g["dim_input100"] = int(h100.dim)

    # -- input104 E0 (input100 + AnisotropyD=7; same oracle route)
    inp104, m104 = _model(INPUT104)
    b104 = m104.create_basis((3, 3))
    h104 = m104.hamiltonian(b104, dtype=np.complex128)
    op4 = spla.LinearOperator(
        (h104.dim, h104.dim),
        matvec=lambda v: host_matvec_f64(h104, v),
        dtype=np.complex128)
    g["e0_input104"] = float(spla.eigsh(
        op4, k=1, which="SA", return_eigenvectors=False, tol=1e-12)[0])

    # -- t-J chain continued-fraction G(omega) (dense Lehmann oracle)
    _, mtj = _model(TJ8)
    gtj = _lehmann_cf(mtj, (3, 3), 0, 0)
    g["gf_tj_omegas"] = OMEGAS.tolist()
    g["gf_tj_delta"] = DELTA
    g["gf_tj_re"] = np.real(gtj).tolist()
    g["gf_tj_im"] = np.imag(gtj).tolist()

    # -- FTLM thermal point (same estimator, f64, same seed)
    _, mh = _model(HUB10)
    bh = mh.create_basis((2, 2))
    hh = mh.hamiltonian(bh, dtype=np.float64)
    res = ftlm(hh, np.asarray(FTLM_BETA), num_vectors=FTLM_VECTORS,
               steps=FTLM_STEPS, seed=FTLM_SEED)
    g["ftlm_hub10_energy"] = [float(x) for x in res.energy]
    g["ftlm_hub10_log_z"] = [float(x) for x in res.log_z]
    return g


def run_onchip(goldens):
    """Run the production pipelines at the ambient dtype and return
    {field: relative error vs golden}.  On the GPU the ambient dtype is
    f32/c64 (+ RQI refinement); on CPU x64 this reproduces the goldens
    to f64 accuracy (pinned by tests/test_onchip_correctness.py)."""
    from lanczosplusplus_tpu.engine import Engine
    from lanczosplusplus_tpu.engine.ftlm import ftlm

    out = {}
    # E0s through the production Engine (assembly + solve + refinement)
    inp0, m0 = _model(INPUT0)
    eng0 = Engine(m0, inp0)
    out["e0_input0_rel_err"] = abs(
        eng0.ground_energy - goldens["e0_input0"]) / abs(
        goldens["e0_input0"])

    inp10, m10 = _model(INPUT10)
    eng10 = Engine(m10, inp10)
    out["e0_input10_rel_err"] = abs(
        eng10.ground_energy - goldens["e0_input10"]) / abs(
        goldens["e0_input10"])

    inp100, m100 = _model(INPUT100)
    eng100 = Engine(m100, inp100)
    out["e0_input100_rel_err"] = abs(
        eng100.ground_energy - goldens["e0_input100"]) / abs(
        goldens["e0_input100"])

    if "e0_input104" in goldens:
        inp104, m104 = _model(INPUT104)
        eng104 = Engine(m104, inp104)
        out["e0_input104_rel_err"] = abs(
            eng104.ground_energy - goldens["e0_input104"]) / abs(
            goldens["e0_input104"])

    # continued-fraction G(omega) on the t-J chain vs the Lehmann
    # oracle curve (production double-sector Lanczos CF)
    inptj, mtj = _model(TJ8)
    engtj = Engine(mtj, inptj)
    coll, _ = engtj.spectral_function("c", 0, 0, spin=0)
    got = coll.evaluate(np.asarray(goldens["gf_tj_omegas"]),
                        goldens["gf_tj_delta"])
    want = (np.asarray(goldens["gf_tj_re"])
            + 1j * np.asarray(goldens["gf_tj_im"]))
    scale = np.abs(want).max()
    out["gf_tj_max_rel_err"] = float(
        np.abs(got - want).max() / scale)

    # two-point correlator row (one-GEMM production path)
    c = eng0.two_point("c", spin=(0, 0))
    row = np.real(np.asarray(c[0, :]))
    want_row = np.asarray(goldens["two_point_row_input0"])
    out["two_point_max_abs_err"] = float(
        np.abs(row - want_row).max())

    # FTLM thermal point (same seed as the golden run)
    _, mh = _model(HUB10)
    basis_h = mh.create_basis((2, 2))
    import jax

    dtype = (np.float64 if jax.config.read("jax_enable_x64")
             else np.float32)
    hh = mh.hamiltonian(basis_h, dtype=dtype)
    res = ftlm(hh, np.asarray(FTLM_BETA), num_vectors=FTLM_VECTORS,
               steps=FTLM_STEPS, seed=FTLM_SEED)
    want_e = np.asarray(goldens["ftlm_hub10_energy"])
    out["ftlm_energy_rel_err"] = float(
        np.abs((np.asarray(res.energy) - want_e) / want_e).max())
    want_lz = np.asarray(goldens["ftlm_hub10_log_z"])
    out["ftlm_log_z_abs_err"] = float(
        np.abs(np.asarray(res.log_z) - want_lz).max())
    return out


def load_goldens():
    with open(GOLDENS_PATH) as f:
        return json.load(f)


def main():
    # standalone runs are CPU utilities (golden generation / the f64
    # reproduction check); the chip measurement goes through bench.py
    # and chip_smoke.py, which import run_onchip directly
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    if "--write" in sys.argv:
        g = compute_goldens()
        with open(GOLDENS_PATH, "w") as f:
            json.dump(g, f, indent=1)
        print(f"wrote {GOLDENS_PATH}")
        return
    out = run_onchip(load_goldens())
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    main()
