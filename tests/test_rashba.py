"""Rashba SOC model tests: hermiticity, analytic dispersion oracle
(scripts/dispersion.pl6), dense cross-checks, input10.inp."""

import numpy as np
import pytest

from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine import Engine

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
hubbardU 4
0 0 0 0
potentialV 8
0 0 0 0
0 0 0 0
SolverOptions=MatrixVectorStored,dumpmatrix,printmatrix
Version=version
OutputFile=data10
TargetElectronsTotal=1
IsPeriodicX=0
"""


def dispersion_oracle(L, t, r, periodic=False):
    """scripts/dispersion.pl6: eigenvalues (t +- r) * (-2 cos k)."""
    out = []
    for mm in range(L):
        m = mm if periodic else mm + 1
        k = 2 * np.pi * m / L if periodic else np.pi * m / (L + 1)
        sk = -2.0 * np.cos(k)
        out += [(t + r) * sk, (t - r) * sk]
    return np.sort(np.array(out))


def test_input10_single_particle_spectrum():
    inp = parse_input(INPUT10)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis(("ne", 1))
    assert basis.size == 8
    ham = model.hamiltonian(basis)
    dense = ham.to_dense()
    np.testing.assert_allclose(dense, dense.T.conj(), atol=1e-12)
    evals = np.linalg.eigvalsh(dense)
    expect = dispersion_oracle(4, -1.0, 7.0)
    np.testing.assert_allclose(evals, expect, atol=1e-10)


def test_two_particle_hermitian_and_engine():
    text = INPUT10.replace("TargetElectronsTotal=1",
                           "TargetElectronsTotal=2") \
        .replace("Connectors 1 7.0", "Connectors 1 0.9") \
        .replace("hubbardU 4\n0 0 0 0", "hubbardU 4\n3 3 3 3")
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis(("ne", 2))
    assert basis.size == 28  # C(8, 2)
    ham = model.hamiltonian(basis)
    dense = ham.to_dense()
    np.testing.assert_allclose(dense, dense.T.conj(), atol=1e-12)
    eng = Engine(model, inp)
    expect = np.linalg.eigvalsh(dense)[0]
    assert eng.ground_energy == pytest.approx(expect, abs=1e-10)


def test_rashba_zero_reduces_to_hubbard():
    """r=0: spectrum must be the union of fixed-(nup,ndown) Hubbard
    sectors with nup+ndown=N."""
    text = INPUT10.replace("Connectors 1 7.0", "Connectors 1 0.0") \
        .replace("TargetElectronsTotal=1", "TargetElectronsTotal=3") \
        .replace("hubbardU 4\n0 0 0 0", "hubbardU 4\n2 2 2 2")
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis(("ne", 3))
    dense = model.hamiltonian(basis).to_dense()
    evals = np.sort(np.linalg.eigvalsh(dense))

    # union of Hubbard sectors
    htext = """
TotalNumberOfSites=4
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1
Model=HubbardOneBand
hubbardU 4
2 2 2 2
potentialV 8
0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=2
TargetElectronsDown=1
IsPeriodicX=0
"""
    hinp = parse_input(htext)
    hgeom = Geometry(hinp)
    hmodel = build_model(hinp, hgeom)
    all_evals = []
    for nup in range(4):
        ndown = 3 - nup
        hb = hmodel.create_basis((nup, ndown))
        all_evals.append(np.linalg.eigvalsh(hmodel.hamiltonian(hb).to_dense()))
    expect = np.sort(np.concatenate(all_evals))
    np.testing.assert_allclose(evals, expect, atol=1e-10)


def test_n_operator_map():
    inp = parse_input(INPUT10.replace("TargetElectronsTotal=1",
                                      "TargetElectronsTotal=2"))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    eng = Engine(model, inp)
    res = eng.two_point("n", spin=(0, 0))
    # total up-occupation: sum_i <n_i_up> must be <N_up> in [0, 2]
    tot = np.trace(res).real
    assert 0 <= tot <= 2 + 1e-9


def test_two_particle_rashba_brute_force():
    """Independent second-quantized oracle for the spin-flip terms at
    N=2 (the 1-particle dispersion cannot see multi-particle crossing
    signs)."""
    text = INPUT10.replace("TargetElectronsTotal=1",
                           "TargetElectronsTotal=2") \
        .replace("Connectors 1 7.0", "Connectors 1 0.8") \
        .replace("hubbardU 4\n0 0 0 0", "hubbardU 4\n1.5 1.5 1.5 1.5")
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis(("ne", 2))
    dense = model.hamiltonian(basis).to_dense()

    # Fock space brute force over 8 modes (up 0-3, down 4-7), JW order
    # mode index ascending; basis ordering matched to RashbaBasis:
    # blocks ndown=0,1,2; within block idn fastest
    nsite = 4
    t = geom.coupling_matrix(0)
    r = geom.coupling_matrix(1)
    u = 1.5

    def jw_sign(state, mode):
        return -1 if bin(state & ((1 << mode) - 1)).count("1") & 1 else 1

    def c_op(state, mode):
        if not (state >> mode) & 1:
            return None
        return state ^ (1 << mode), jw_sign(state, mode)

    def cdag_op(state, mode):
        if (state >> mode) & 1:
            return None
        return state ^ (1 << mode), jw_sign(state, mode)

    # build states from the block listing (matches RashbaBasis order)
    states = []
    for ndown in range(3):
        blk = basis.block(ndown)
        if blk is None:
            continue
        up_b, dn_b, off = blk
        for iu in range(up_b.size):
            for idn in range(dn_b.size):
                fock = int(up_b.words[iu]) | (int(dn_b.words[idn]) << 4)
                states.append(fock)
    index = {s: k for k, s in enumerate(states)}
    dim = len(states)
    H = np.zeros((dim, dim))
    for s, row in index.items():
        for i in range(nsite):
            nu = (s >> i) & 1
            nd = (s >> (i + 4)) & 1
            H[row, row] += u * nu * nd
            for j in range(nsite):
                if i == j:
                    continue
                # hopping both spins: t_ij c^dag_j c_i
                for off_m in (0, 4):
                    if t[i, j] == 0:
                        continue
                    r1 = c_op(s, i + off_m)
                    if r1 is None:
                        continue
                    r2 = cdag_op(r1[0], j + off_m)
                    if r2 is None:
                        continue
                    H[index[r2[0]], row] += t[i, j] * r1[1] * r2[1]
                # rashba: r_ij (c^dag_{j up} c_{i down} + h.c.)
                if r[i, j] != 0:
                    r1 = c_op(s, i + 4)
                    if r1 is not None:
                        r2 = cdag_op(r1[0], j)
                        if r2 is not None:
                            H[index[r2[0]], row] += r[i, j] * r1[1] * r2[1]
                    r1 = c_op(s, i)
                    if r1 is not None:
                        r2 = cdag_op(r1[0], j + 4)
                        if r2 is not None:
                            H[index[r2[0]], row] += r[i, j] * r1[1] * r2[1]
    np.testing.assert_allclose(np.linalg.eigvalsh(dense),
                               np.linalg.eigvalsh(H), atol=1e-10)
    np.testing.assert_allclose(dense, H, atol=1e-10)


def test_block_kron_matches_flat_ell():
    """The block-Kronecker form (GEMM path) equals the flat ELL
    Hamiltonian elementwise, real and complex."""
    import jax.numpy as jnp

    for use_complex, rval in ((False, "0.7"), (True, "(0.4,0.3)")):
        text = INPUT10.replace("Connectors 1 7.0",
                               f"Connectors 1 {rval}") \
                      .replace("TargetElectronsTotal=1",
                               "TargetElectronsTotal=3") \
                      .replace("hubbardU 4\n0 0 0 0",
                               "hubbardU 4\n2 2 2 2") \
                      .replace("potentialV 8\n0 0 0 0\n0 0 0 0",
                               "potentialV 8\n.1 .2 .3 .4\n"
                               ".1 .2 .3 .4")
        inp = parse_input(text)
        geom = Geometry(inp)
        model = build_model(inp, geom)
        basis = model.create_basis(("ne", 3))
        dtype = np.complex128 if use_complex else np.float64
        flat = model.hamiltonian(basis, dtype=dtype)
        bk = model.block_kron_hamiltonian(basis, dtype=dtype)
        assert bk.dim == flat.dim
        d_flat = flat.to_dense()
        d_bk = bk.to_dense()
        np.testing.assert_allclose(d_bk, d_flat, atol=1e-12)
        # hermiticity of the block form
        np.testing.assert_allclose(d_bk, d_bk.conj().T, atol=1e-12)
        # batched apply agrees with matvec
        rng = np.random.default_rng(0)
        xk = rng.standard_normal((3, bk.dim)).astype(
            np.complex128 if use_complex else np.float64)
        y1 = np.asarray(bk.matmat_t(jnp.asarray(xk)))
        y2 = np.stack([np.asarray(bk.matvec(jnp.asarray(xk[i])))
                       for i in range(3)])
        np.testing.assert_allclose(y1, y2, atol=1e-10)


def test_factored_engine_rashba():
    """SolverOptions=factored routes Rashba through the block-Kron
    form and reproduces the flat-path ground energy."""
    text = INPUT10.replace("TargetElectronsTotal=1",
                           "TargetElectronsTotal=2")
    e_flat = Engine(
        build_model(parse_input(text), Geometry(parse_input(text))),
        parse_input(text)).ground_energy
    text_f = text.replace(
        "SolverOptions=MatrixVectorStored,dumpmatrix,printmatrix",
        "SolverOptions=factored")
    inp = parse_input(text_f)
    eng = Engine(build_model(inp, Geometry(inp)), inp)
    assert eng.ground_energy == pytest.approx(e_flat, abs=1e-9)
