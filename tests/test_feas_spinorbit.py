"""FeAs spin-orbit variant: hermiticity, zero-SO reduction to sector
union, kron oracle for the SO operator."""

import numpy as np
import pytest

from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine import Engine


def so_text(nsite, nup, ndown, so_vals, u=(1.0, 0.5, -0.2, -0.1)):
    orbitals = 2
    n2 = nsite * orbitals * 2
    so_lines = "\n".join(" ".join(str(x) for x in so_vals[r * 4:(r + 1) * 4])
                         for r in range(4))
    return f"""
TotalNumberOfSites={nsite}
Model=FeAsBasedSc
FeAsMode=INT_PAPER33
NumberOfTerms=1
DegreesOfFreedom=2
Orbitals=2
GeometryKind=chain
GeometryOptions=ConstantValues
SolverOptions=none
hubbardU 4 {" ".join(str(x) for x in u)}
Connectors 2 2
-1.0 0.2
0.2 -0.7
potentialV {n2}
{" ".join(["0"] * n2)}
SpinOrbit 4 4
{so_lines}
TargetElectronsUp={nup}
TargetElectronsDown={ndown}
IsPeriodicX=0
"""


def test_spin_orbit_basis_size():
    # diagonal-only SO (no spin mixing) keeps hermiticity trivially
    so = [0.0] * 16
    inp = parse_input(so_text(2, 1, 1, so))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((1, 1))
    from math import comb
    # union over nup = 0..2 of product blocks
    assert basis.size == sum(comb(4, k) * comb(4, 2 - k) for k in range(3))


def test_zero_so_reduces_to_sector_union():
    so = [0.0] * 16
    inp = parse_input(so_text(2, 1, 1, so))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((1, 1))
    dense = model.hamiltonian(basis).to_dense()
    np.testing.assert_allclose(dense, dense.T.conj(), atol=1e-12)
    evals = np.sort(np.linalg.eigvalsh(dense).real)
    # union of fixed-(nup,ndown) FeAs sectors with nup+ndown=2
    text2 = so_text(2, 1, 1, so)
    text2 = "\n".join(ln for ln in text2.splitlines()
                      if not ln.startswith("SpinOrbit") and
                      ln.strip() not in ("0.0 0.0 0.0 0.0",))
    inp2 = parse_input(text2)
    model2 = build_model(inp2, Geometry(inp2))
    union = []
    for nup in range(3):
        b = model2.create_basis((nup, 2 - nup))
        union.append(np.linalg.eigvalsh(model2.hamiltonian(b).to_dense()))
    expect = np.sort(np.concatenate(union))
    np.testing.assert_allclose(evals, expect, atol=1e-10)


def test_spin_mixing_hermitian_and_engine():
    # hermitian SO matrix: rows indexed spin1+2*spin2, cols orb1+2*orb2.
    # hermiticity of H requires SO[s1+2s2, o1+2o2] = conj(SO[s2+2s1, o2+2o1])
    so = np.zeros((4, 4))
    # diagonal spin blocks: symmetric orbital matrix
    so[0, :] = [0.3, 0.1, 0.1, -0.3]
    so[3, :] = [-0.3, 0.1, 0.1, 0.3]
    # spin-flip blocks: SO[1] = up->down coupling, SO[2] its conjugate
    so[1, :] = [0.2, 0.05, 0.07, -0.2]
    so[2, :] = [0.2, 0.07, 0.05, -0.2]
    inp = parse_input(so_text(2, 1, 1, list(so.reshape(-1))))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((1, 1))
    dense = model.hamiltonian(basis).to_dense()
    np.testing.assert_allclose(dense, dense.T.conj(), atol=1e-11)
    eng = Engine(model, inp)
    expect = np.linalg.eigvalsh(dense)[0].real
    assert eng.ground_energy == pytest.approx(expect, abs=1e-9)


def test_spin_orbit_fock_space_oracle():
    """Element-wise second-quantized oracle.

    The reference's doSignSpinOrbit interval convention
    (BasisFeAsBasedSc.h:180-200 / BasisOneSpinFeAs doSign counting the
    source bit) carries one extra minus sign on every SO hop relative
    to textbook Jordan-Wigner, i.e. the implemented operator is
    H_SO = - sum SO[s1+2*s2, o1+2*o2] c^dag_{i,o2,s2} c_{i,o1,s1}
    (off-diagonal part; the diagonal n-terms are unaffected).  We
    reproduce the reference convention faithfully — users' SpinOrbit
    matrices keep their meaning — and this test pins the exact
    relation against the textbook construction."""
    so = np.zeros((4, 4))
    so[0, :] = [0.15, 0.3, 0.3, -0.15]
    so[3, :] = [-0.15, 0.3, 0.3, 0.15]
    so[1, :] = [0.25, 0.1, 0.2, -0.25]
    so[2, :] = [0.25, 0.2, 0.1, -0.25]
    inp = parse_input(so_text(2, 1, 1, list(so.reshape(-1)),
                              u=(1.3, 0.6, -0.2, -0.15)))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((1, 1))
    dense = model.hamiltonian(basis).to_dense()

    nsite, o = 2, 2
    nb = nsite * o
    t = model.hop  # already includes the FeAs minus sign
    u = model.u

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

    states = []
    for k in range(basis.size):
        fock = int(basis.up_words[k]) | (int(basis.dn_words[k]) << nb)
        states.append(fock)
    index = {s: k for k, s in enumerate(states)}
    H = np.zeros((len(states), len(states)))
    for s, row in index.items():
        # diagonal: U0/U1/U4/U5 + SO diagonal
        for i in range(nsite):
            for orb in range(o):
                a = i * o + orb
                nu = (s >> a) & 1
                nd = (s >> (a + nb)) & 1
                H[row, row] += u[0] * nu * nd
                H[row, row] += so[0, orb + orb * o] * nu + \
                    so[3, orb + orb * o] * nd
                for orb2 in range(orb + 1, o):
                    b = i * o + orb2
                    nu2 = (s >> b) & 1
                    nd2 = (s >> (b + nb)) & 1
                    H[row, row] += u[1] * (nu + nd) * (nu2 + nd2)
                    H[row, row] += u[4] * 0.25 * (nu - nd) * (nu2 - nd2)
                    H[row, row] += u[5] * (nu * nu2 + nd * nd2)
        # hopping both spins
        for a in range(nb):
            for b in range(nb):
                if a == b or t[a, b] == 0:
                    continue
                for off_m in (0, nb):
                    r1 = c_op(s, a + off_m)
                    if r1 is None:
                        continue
                    r2 = cdag_op(r1[0], b + off_m)
                    if r2 is None:
                        continue
                    H[index[r2[0]], row] += t[a, b] * r1[1] * r2[1]
        # U2 / U3 onsite quartics
        for i in range(nsite):
            for o1 in range(o):
                for o2 in range(o):
                    if o1 == o2:
                        continue
                    a, b = i * o + o1, i * o + o2
                    # 0.5*U2 S+_{o1}S-_{o2}: c^dag_{a,u} c_{a,d}
                    #                         c^dag_{b,d} c_{b,u}
                    cur = c_op(s, b)
                    if cur is not None:
                        cur2 = cdag_op(cur[0], b + nb)
                        if cur2 is not None:
                            cur3 = c_op(cur2[0], a + nb)
                            if cur3 is not None:
                                cur4 = cdag_op(cur3[0], a)
                                if cur4 is not None:
                                    amp = 0.5 * u[2] * cur[1] * cur2[1] * \
                                        cur3[1] * cur4[1]
                                    H[index[cur4[0]], row] += amp
                    # U3 pair hop b -> a: -U3? reference amp
                    # = -U3 * jTermSign; in operator form
                    # +(-U3)... use c^dag_{a,u} c^dag_{a,d} c_{b,d} c_{b,u}
                    cur = c_op(s, b)
                    if cur is not None:
                        cur2 = c_op(cur[0], b + nb)
                        if cur2 is not None:
                            cur3 = cdag_op(cur2[0], a + nb)
                            if cur3 is not None:
                                cur4 = cdag_op(cur3[0], a)
                                if cur4 is not None:
                                    amp = -u[3] * cur[1] * cur2[1] * \
                                        cur3[1] * cur4[1]
                                    H[index[cur4[0]], row] += amp
        # spin-orbit off-diagonal
        for i in range(nsite):
            for o1 in range(o):
                for o2 in range(o):
                    for s1 in range(2):
                        for s2 in range(2):
                            if s1 == s2 and o1 == o2:
                                continue
                            val = so[s1 + 2 * s2, o1 + o * o2]
                            if val == 0:
                                continue
                            m1 = i * o + o1 + (nb if s1 else 0)
                            m2 = i * o + o2 + (nb if s2 else 0)
                            r1 = c_op(s, m1)
                            if r1 is None:
                                continue
                            r2 = cdag_op(r1[0], m2)
                            if r2 is None:
                                continue
                            # reference convention: extra minus on
                            # every SO hop (see docstring)
                            H[index[r2[0]], row] += -val * r1[1] * r2[1]
    np.testing.assert_allclose(dense, H, atol=1e-10)


@pytest.mark.parametrize("nsite,nup,ndown,so", [
    (2, 1, 1, [0.3, 0.2, 0.1, 0.05,
               0.2, -0.3, 0.05, 0.15,
               0.1, 0.05, 0.25, 0.1,
               0.05, 0.15, 0.1, -0.25]),
    (3, 2, 1, [0.3, 0.0, 0.1, 0.0,
               0.0, -0.3, 0.0, 0.1,
               0.1, 0.0, 0.25, 0.0,
               0.0, 0.1, 0.0, -0.25]),
    (2, 2, 1, [0.4, 0.2, 0.0, 0.1,
               0.2, -0.4, 0.1, 0.0,
               0.0, 0.1, 0.2, 0.05,
               0.1, 0.0, 0.05, -0.2]),
])
def test_block_kron_matches_flat(nsite, nup, ndown, so):
    """The block-Kronecker form (GEMM/perm-gather path) equals the flat
    gather-ELL Hamiltonian elementwise."""
    from lanczosplusplus_tpu.models.feas_spinorbit_factored import \
        build_factored_feas_spinorbit

    inp = parse_input(so_text(nsite, nup, ndown, so))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((nup, ndown))
    flat = model.hamiltonian(basis).to_dense()
    fact = build_factored_feas_spinorbit(model, basis)
    assert fact.dim == basis.size
    dense = fact.to_dense()
    np.testing.assert_allclose(dense, flat, atol=1e-11)


def test_block_kron_with_anisotropy():
    from lanczosplusplus_tpu.models.feas_spinorbit_factored import \
        build_factored_feas_spinorbit

    so = [0.3, 0.2, 0.1, 0.05,
          0.2, -0.3, 0.05, 0.15,
          0.1, 0.05, 0.25, 0.1,
          0.05, 0.15, 0.1, -0.25]
    text = so_text(2, 1, 1, so).replace(
        "SolverOptions=none", "SolverOptions=none\nAnisotropyD=0.7")
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((1, 1))
    flat = model.hamiltonian(basis).to_dense()
    fact = build_factored_feas_spinorbit(model, basis)
    np.testing.assert_allclose(fact.to_dense(), flat, atol=1e-11)


def test_factored_engine_matches_flat():
    so = [0.3, 0.2, 0.1, 0.05,
          0.2, -0.3, 0.05, 0.15,
          0.1, 0.05, 0.25, 0.1,
          0.05, 0.15, 0.1, -0.25]
    text = so_text(2, 1, 1, so)
    inp = parse_input(text)
    e_flat = Engine(build_model(inp, Geometry(inp)), inp).ground_energy
    text_f = text.replace("SolverOptions=none",
                          "SolverOptions=factored,useComplex")
    inp_f = parse_input(text_f)
    eng = Engine(build_model(inp_f, Geometry(inp_f)), inp_f)
    assert eng.ground_energy == pytest.approx(e_flat, abs=1e-9)
