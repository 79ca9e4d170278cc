"""Momentum-projected Lanczos (symmetry/projected.py): the projected
translation-sector solver must reproduce the orbit-block spectra."""

import numpy as np
import pytest

from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.models.kitaev_factored import \
    build_factored_kitaev
from lanczosplusplus_tpu.symmetry import TranslationSymmetry
from lanczosplusplus_tpu.symmetry.projected import (
    ProjectedTranslationSolver, RotationProjectedHamiltonian,
    rotation_weights)


def _kitaev(n, jx=1.1, jy=0.7, jz=0.9):
    term = ("DegreesOfFreedom=1\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nConnectors 1 {v}\n")
    text = (f"TotalNumberOfSites={n}\nNumberOfTerms=3\n"
            + term.format(v=jx) + term.format(v=jy) + term.format(v=jz)
            + "Model=Kitaev\nSolverOptions=none\nIsPeriodicX=1\n")
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    return inp, geom, model, model.create_basis(None)


def test_rotation_is_translation():
    """The reshape-transpose T^g equals the word-rotation gather."""
    n = 6
    dim = 1 << n
    rng = np.random.default_rng(3)
    v = rng.standard_normal(dim)
    mask = dim - 1
    for g in range(1, n):
        # T^g v [u] = v[rotr_g(u)]
        u = np.arange(dim)
        rot = ((u >> g) | ((u & ((1 << g) - 1)) << (n - g))) & mask
        want = v[rot]
        got = v.reshape(1 << g, -1).T.reshape(-1)
        np.testing.assert_array_equal(got, want)


def test_projector_weights_partition():
    """sum_k P_k = identity over the real sector projectors."""
    for n in (6, 7, 8):
        total = np.zeros(n)
        for k in range(n // 2 + 1):
            total += rotation_weights(n, k)
        want = np.zeros(n)
        want[0] = 1.0
        np.testing.assert_allclose(total, want, atol=1e-12)


def test_projected_sector_energies_match_blocks():
    """Per-k ground energies from the projected solver equal the
    orbit-block ones (real projector spans the degenerate (k, -k)
    pair, whose block spectra are equal)."""
    n = 8
    inp, geom, model, basis = _kitaev(n)
    fac = build_factored_kitaev(model, basis, dtype=np.float64)
    sym = TranslationSymmetry(basis, geom, model, fermionic=False)
    block_e0 = {}
    for s in range(sym.sectors()):
        blk = sym.block_hamiltonian(s)
        if blk is None or blk.dim == 0:
            continue
        kx = sym._momenta[s][0]
        block_e0[kx] = float(np.linalg.eigvalsh(blk.to_dense())[0])

    proj = ProjectedTranslationSolver(fac, n)
    for s in range(proj.sectors()):
        k = proj.momentum(s)
        evals, vecs, info = proj.solve_sector(s, max_steps=120)
        want = min(block_e0[k], block_e0[(n - k) % n])
        assert float(evals[0]) == pytest.approx(want, abs=1e-8), k
        # the eigenvector is a clean sector vector
        assert proj.purity(s, vecs[0]) == pytest.approx(1.0, abs=1e-8)


def test_engine_projected_translation_dispatch():
    """Engine routes Kitaev + UseTranslationSymmetry=1 through the
    projected solver (SolverOptions=projected forces it on CPU) and
    reports solve_info, sector and purity."""
    from lanczosplusplus_tpu.engine import Engine

    n = 8
    term = ("DegreesOfFreedom=1\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nConnectors 1 {v}\n")
    text = (f"TotalNumberOfSites={n}\nNumberOfTerms=3\n"
            + term.format(v=1.1) + term.format(v=0.7)
            + term.format(v=0.9)
            + "Model=Kitaev\nSolverOptions=projected\nIsPeriodicX=1\n"
            + "UseTranslationSymmetry=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    eng = Engine(model, inp)
    inp2 = parse_input(text.replace("UseTranslationSymmetry=1\n", "")
                       .replace("SolverOptions=projected",
                                "SolverOptions=none"))
    eng2 = Engine(build_model(inp2, Geometry(inp2)), inp2)
    assert eng.ground_energy == pytest.approx(eng2.ground_energy,
                                              abs=1e-9)
    assert eng.solve_info is not None
    assert eng.projected_purity == pytest.approx(1.0, abs=1e-8)
    # eigenvector solves the full H
    v = np.asarray(eng.eigenvector(0))
    full = np.asarray(eng2.hamiltonian.to_dense())
    r = np.linalg.norm(full @ v - eng.ground_energy * v)
    assert r < 1e-7


def test_projected_min_k_equals_unsymmetrized():
    n = 10
    inp, geom, model, basis = _kitaev(n)
    fac = build_factored_kitaev(model, basis, dtype=np.float64)
    from lanczosplusplus_tpu.solver import lanczos as lz
    e_plain, _ = lz.lowest_states(fac, max_steps=200)
    proj = ProjectedTranslationSolver(fac, n)
    e_min = min(float(proj.solve_sector(s, max_steps=200)[0][0])
                for s in range(proj.sectors()))
    assert e_min == pytest.approx(float(e_plain[0]), abs=1e-8)
