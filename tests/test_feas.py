"""FeBasedSc tests: naive per-state transcription of the reference
algorithm as vectorization oracle + physical limits + input100."""

import numpy as np
import pytest

from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.engine import Engine
from reference_inputs import input_path


def feas_input(nsite, nup, ndown, orbitals=2, u=(1.0, 0.6, -0.2, -0.1),
               t=(-1.0, 0.0, 0.0, -1.0), pv=None, aniso=0.0):
    n2 = nsite * orbitals * 2
    pv = pv or [0.0] * n2
    tm = f"{t[0]} {t[1]}\n{t[2]} {t[3]}"
    return f"""
TotalNumberOfSites={nsite}
Model=FeAsBasedSc
FeAsMode=INT_PAPER33
NumberOfTerms=1
DegreesOfFreedom={orbitals}
Orbitals={orbitals}
GeometryKind=chain
GeometryOptions=ConstantValues
SolverOptions=none
hubbardU {len(u)} {" ".join(str(x) for x in u)}
Connectors {orbitals} {orbitals}
{tm}
potentialV {n2}
{" ".join(str(x) for x in pv)}
TargetElectronsUp={nup}
TargetElectronsDown={ndown}
IsPeriodicX=0
AnisotropyD={aniso}
"""


def naive_reference_hamiltonian(model, basis):
    """Line-by-line Python transcription of the reference's assembly
    (FeBasedSc.h setupHamiltonian for INT_PAPER33, no J terms)."""
    o = model.norb
    n = model.geometry.number_of_sites()
    u = model.u
    upw = basis.up.words.astype(int)
    dnw = basis.down.words.astype(int)
    szu = basis.up.size
    dim = basis.size

    def bit(w, x):
        return (w >> x) & 1

    def count(w, lo, hi):
        return sum(bit(w, x) for x in range(lo, hi))

    def dosign(w, i, o1, j, o2):
        if i == j:
            if o1 > o2:
                return -dosign(w, i, o2, j, o1)
            return -1 if count(w, i * o + o1, i * o + o2) & 1 else 1
        s = count(w, (i + 1) * o, j * o)
        s += count(w, i * o + o1, (i + 1) * o)
        s += count(w, j * o, j * o + o2)
        return -1 if s & 1 else 1

    def rank(uw, dw):
        iu = int(basis.up.rank(np.array([uw], dtype=np.uint64))[0])
        idn = int(basis.down.rank(np.array([dw], dtype=np.uint64))[0])
        return iu + idn * szu

    H = np.zeros((dim, dim))
    for row in range(dim):
        ket1 = int(upw[row % szu])
        ket2 = int(dnw[row // szu])
        # diagonal
        s = 0.0
        for i in range(n):
            sz_site = 0.0
            for orb in range(o):
                a = i * o + orb
                nu_a, nd_a = bit(ket1, a), bit(ket2, a)
                s += u[0] * nu_a * nd_a
                for orb2 in range(orb + 1, o):
                    b = i * o + orb2
                    nu_b, nd_b = bit(ket1, b), bit(ket2, b)
                    s += u[1] * (nu_a + nd_a) * (nu_b + nd_b)
                    s += u[4] * 0.25 * (nu_a - nd_a) * (nu_b - nd_b)
                    s += u[5] * (nu_a * nu_b + nd_a * nd_b)
                s += model.potential_v[i + orb * n] * nu_a
                s += model.potential_v[i + (orb + o) * n] * nd_a
                sz_site += 0.5 * (nu_a - nd_a)
            s += model.anisotropy_d * sz_site * sz_site
        H[row, row] += s
        # hopping
        for i in range(n):
            for orb in range(o):
                ii = i * o + orb
                s1i, s2i = bit(ket1, ii), bit(ket2, ii)
                for j in range(i, n):
                    for orb2 in range(o):
                        jj = j * o + orb2
                        if jj == ii:
                            continue
                        h = model.hop[ii, jj]
                        if h == 0:
                            continue
                        s1j, s2j = bit(ket1, jj), bit(ket2, jj)
                        if s1i + s1j == 1:
                            bra1 = ket1 ^ (1 << ii) ^ (1 << jj)
                            extra = -1 if s1i == 1 else 1
                            sg = dosign(ket1, i, orb, j, orb2)
                            H[row, rank(bra1, ket2)] += h * extra * sg
                        if s2i + s2j == 1:
                            bra2 = ket2 ^ (1 << ii) ^ (1 << jj)
                            extra = -1 if s2i == 1 else 1
                            sg = dosign(ket2, i, orb, j, orb2)
                            H[row, rank(ket1, bra2)] += h * extra * sg
                # U2 and U3 onsite
                for orb2 in range(o):
                    if orb2 == orb:
                        continue
                    jj = i * o + orb2
                    sign = dosign(ket1, i, orb, i, orb2) * \
                        dosign(ket2, i, orb, i, orb2)
                    # U2: S+_{orb} S-_{orb2}
                    if bit(ket1, jj) == 1 and bit(ket1, ii) == 0 and \
                            bit(ket2, ii) == 1 and bit(ket2, jj) == 0:
                        bra1 = ket1 ^ (1 << ii) ^ (1 << jj)
                        bra2 = ket2 ^ (1 << ii) ^ (1 << jj)
                        H[row, rank(bra1, bra2)] += 0.5 * u[2] * sign
                    # U3: pair hops orb2 -> orb
                    if bit(ket1, jj) == 1 and bit(ket1, ii) == 0 and \
                            bit(ket2, ii) == 0 and bit(ket2, jj) == 1:
                        bra1 = ket1 ^ (1 << ii) ^ (1 << jj)
                        bra2 = ket2 ^ (1 << ii) ^ (1 << jj)
                        H[row, rank(bra1, bra2)] += -u[3] * sign
    return H


@pytest.mark.parametrize("nup,ndown", [(1, 1), (2, 2), (2, 1)])
def test_feas_matches_naive_reference(nup, ndown):
    inp = parse_input(feas_input(2, nup, ndown,
                                 u=(1.3, 0.6, -0.2, -0.15, -0.33, 0.17),
                                 t=(-1.0, 0.3, 0.3, -0.7),
                                 pv=[0.1, -0.2, 0.05, 0.0,
                                     0.0, 0.3, -0.1, 0.2],
                                 aniso=0.21))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((nup, ndown))
    dense = model.hamiltonian(basis).to_dense()
    np.testing.assert_allclose(dense, dense.T, atol=1e-12)
    naive = naive_reference_hamiltonian(model, basis)
    np.testing.assert_allclose(dense, naive, atol=1e-12)


def test_feas_u0_free_fermions():
    """U=0 two-orbital chain: E0 = filled levels of the one-particle
    hopping matrix (with the reference's minus sign)."""
    inp = parse_input(feas_input(3, 2, 2, u=(0, 0, 0, 0),
                                 t=(-1.0, 0.2, 0.2, -0.5)))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    eng = Engine(model, inp)
    h1 = model.hop  # single-particle matrix (6 x 6), already negated
    eps = np.linalg.eigvalsh(h1)
    expect = 2 * eps[:2].sum()
    assert eng.ground_energy == pytest.approx(expect, abs=1e-9)


def test_feas_input100_sector():
    """TestSuite input100.inp: 6-site 2-orbital INT_PAPER33; checks
    hermiticity via matvec and E0 vs ARPACK oracle at dim 48400."""
    with open(input_path("input100.inp")) as f:
        text = f.read()
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((3, 3))
    assert basis.up.size == 220
    ham = model.hamiltonian(basis)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(ham.dim)
    y = rng.standard_normal(ham.dim)
    hx = np.asarray(ham.matvec(x))
    hy = np.asarray(ham.matvec(y))
    assert np.vdot(y, hx) == pytest.approx(np.vdot(x, hy), rel=1e-10)
    import scipy.sparse.linalg as spla
    op = spla.LinearOperator((ham.dim, ham.dim),
                             matvec=lambda v: np.asarray(ham.matvec(v)))
    e = spla.eigsh(op, k=1, which="SA", return_eigenvectors=False)[0]
    eng = Engine(model, inp)
    assert eng.ground_energy == pytest.approx(e, abs=1e-8)


def test_feas_gf_lehmann_small():
    """Green's function on the 2-site 2-orbital model vs Lehmann."""
    inp = parse_input(feas_input(2, 1, 1,
                                 u=(1.0, 0.5, -0.2, -0.1)))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    eng = Engine(model, inp)
    coll, labels = eng.spectral_function("c", 0, 0, spin=0, orbs=(1, 1))
    omegas = np.linspace(-4, 4, 41)
    delta = 0.1
    got = coll.evaluate(omegas, delta)
    from lanczosplusplus_tpu.engine.operators import LabeledOperator
    dense0 = eng.hamiltonian.to_dense()
    e0s, v0s = np.linalg.eigh(dense0)
    gs = v0s[:, 0]
    z = omegas + 1j * delta
    expect = np.zeros_like(z)
    for op_name, sigma in (("cdagger", +1), ("c", -1)):
        op = LabeledOperator(op_name)
        parts_new = model.has_new_parts((1, 1), op, 0, 1)
        if parts_new is None:
            continue
        bas = model.create_basis(parts_new)
        tgt, amp, dst = model.operator_map(op, 0, 0, 1, eng.basis, bas)
        phi = np.zeros(dst)
        mask = tgt >= 0
        np.add.at(phi, tgt[mask], amp[mask] * gs[mask])
        h = model.hamiltonian(bas).to_dense()
        es, vs = np.linalg.eigh(h)
        a = vs.T @ phi
        for m in range(len(es)):
            expect += a[m] ** 2 / (z - sigma * (es[m] - e0s[0]))
    np.testing.assert_allclose(got, expect, atol=1e-8)
