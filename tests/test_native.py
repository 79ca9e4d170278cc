"""Native C++ host-kernel parity tests vs the numpy implementations."""

import numpy as np
import pytest

from lanczosplusplus_tpu import native
from lanczosplusplus_tpu.core.combinatorics import (
    binomial_table, unrank_combinations, rank_combinations)
from lanczosplusplus_tpu.core.sparse import one_spin_ell
from lanczosplusplus_tpu.core.basis import OneSpinBasis



@pytest.fixture(autouse=True)
def _needs_native():
    if not native.available():
        pytest.skip(f"native library unavailable: {native.status()}")


def test_native_enumeration_matches_numpy():
    for nsite, npart in [(18, 9), (20, 6)]:
        got = native.enumerate_combinations(nsite, npart)
        table = binomial_table(nsite + 1)
        dim = int(table[nsite, npart])
        expect = unrank_combinations(np.arange(dim), nsite, npart, table)
        np.testing.assert_array_equal(got, expect)


def test_native_rank_matches_numpy():
    nsite = 18
    words = native.enumerate_combinations(nsite, 9)
    table = binomial_table(64 + 1)
    got = native.rank_combinations(words, table)
    expect = rank_combinations(words, nsite)
    np.testing.assert_array_equal(got, expect)


def test_native_hop_ell_matches_numpy():
    nsite = 18
    basis = OneSpinBasis(nsite, 9)
    assert basis.size == 48620
    bonds = []
    for i in range(nsite - 1):
        bonds.append((i, i + 1, -1.0))
        bonds.append((i + 1, i, -1.0))
    table = binomial_table(64 + 1)
    native_out = native.one_spin_hop_ell(basis.words, bonds, table)
    assert native_out is not None
    cols_n, vals_n = native_out
    # numpy path (force by bypassing the size gate: call directly on a
    # fake small rank_fn owner)
    from lanczosplusplus_tpu.core import bits as B
    from lanczosplusplus_tpu.core.sparse import coo_to_ell
    sz = basis.size
    nb = len(bonds)
    cols = np.tile(np.arange(sz, dtype=np.int64)[:, None], (1, nb))
    vals = np.zeros((sz, nb))
    for k, (i, j, t) in enumerate(bonds):
        occ_i = B.get_bit(basis.words, i)
        occ_j = B.get_bit(basis.words, j)
        ok = (occ_i == 1) & (occ_j == 0)
        sign = B.parity_sign_below(basis.words, i)
        mid = B.flip_bit(basis.words, i)
        sign = sign * B.parity_sign_below(mid, j)
        tgt = np.where(ok, basis.rank(B.flip_bit(mid, j)), np.arange(sz))
        cols[:, k] = tgt
        vals[:, k] = np.where(ok, t * sign, 0)
    np.testing.assert_array_equal(cols_n, cols)
    np.testing.assert_allclose(vals_n, vals)
