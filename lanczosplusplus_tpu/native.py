"""ctypes binding for the native host runtime (native/lanczos_native.cpp).

The native library accelerates the host-side data preparation (basis
enumeration, ranking, ELL assembly) for large sectors; every entry
point has a vectorized numpy fallback in core/, selected automatically
when the library is missing.  The first use runs `make -C native`
(a no-op when the library is newer than its sources), so a library
left over from an older source or another build is rebuilt; `status()`
says whether it loaded and, if not, why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_STATUS = "not loaded yet"


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build() -> str | None:
    """Run make; return an error message, or None on success."""
    try:
        r = subprocess.run(["make", "-C",
                            os.path.join(_repo_root(), "native")],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"build failed: {e}"
    if r.returncode != 0:
        return f"build failed: {r.stderr.strip()[-300:]}"
    return None


def load():
    global _LIB, _TRIED, _STATUS
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(_repo_root(), "native", "liblanczos_native.so")
    err = _build()
    if not os.path.exists(path):
        _STATUS = f"numpy fallback ({err or 'no library after build'})"
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        _STATUS = f"numpy fallback (load failed: {e})"
        return None
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    intp = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

    lib.lpp_enumerate_combinations.restype = ctypes.c_long
    lib.lpp_enumerate_combinations.argtypes = [ctypes.c_int, ctypes.c_int,
                                               u64p]
    lib.lpp_rank_combinations.restype = None
    lib.lpp_rank_combinations.argtypes = [u64p, ctypes.c_long, i64p,
                                          ctypes.c_int, i64p]
    lib.lpp_one_spin_hop_ell.restype = None
    lib.lpp_one_spin_hop_ell.argtypes = [u64p, ctypes.c_long, intp, intp,
                                         f64p, ctypes.c_int, i64p,
                                         ctypes.c_int, i32p, f64p]
    lib.lpp_scatter_plan_count.restype = None
    lib.lpp_scatter_plan_count.argtypes = [i64p, ctypes.c_long,
                                           ctypes.c_long, ctypes.c_long,
                                           ctypes.c_int, i64p]
    lib.lpp_scatter_plan_fill.restype = None
    lib.lpp_scatter_plan_fill.argtypes = [i64p, ctypes.c_long,
                                          ctypes.c_long, ctypes.c_long,
                                          ctypes.c_int, ctypes.c_long,
                                          ctypes.c_char_p, ctypes.c_long,
                                          i32p, ctypes.c_char_p, i32p,
                                          i64p]
    _LIB = lib
    _STATUS = f"loaded {path}" + (f" (stale: {err})" if err else "")
    return _LIB


def available() -> bool:
    return load() is not None


def status() -> str:
    """Outcome of loading the library: 'loaded <path>' or 'numpy
    fallback (<reason>)'."""
    load()
    return _STATUS


def enumerate_combinations(nsite: int, npart: int):
    lib = load()
    if lib is None:
        return None
    from lanczosplusplus_tpu.core.combinatorics import binomial_table
    dim = int(binomial_table(nsite + 1)[nsite, npart]) if npart else 1
    out = np.zeros(max(dim, 1), dtype=np.uint64)
    n = lib.lpp_enumerate_combinations(nsite, npart, out)
    return out[:n]


def rank_combinations(words: np.ndarray, table: np.ndarray):
    lib = load()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    table = np.ascontiguousarray(table, dtype=np.int64)
    out = np.zeros(words.shape[0], dtype=np.int64)
    lib.lpp_rank_combinations(words, words.shape[0], table,
                              table.shape[1], out)
    return out


def scatter_plan_tables(tgt: np.ndarray, amp: np.ndarray, s_src: int,
                        s_dst: int, ndev: int):
    """(send_src, send_amp, dst_idx, maxcount) bucket tables for
    SectorScatterPlan, built in one native pass each for count/fill.
    Returns None when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    tgt = np.ascontiguousarray(tgt, dtype=np.int64)
    amp = np.ascontiguousarray(amp)
    n = tgt.shape[0]
    counts = np.zeros(ndev * ndev, dtype=np.int64)
    lib.lpp_scatter_plan_count(tgt, n, s_src, s_dst, ndev, counts)
    maxcount = max(int(counts.max(initial=0)), 1)
    send_src = np.zeros((ndev, ndev, maxcount), np.int32)
    send_amp = np.zeros((ndev, ndev, maxcount), amp.dtype)
    dst_idx = np.zeros((ndev, ndev, maxcount), np.int32)
    counts[:] = 0
    lib.lpp_scatter_plan_fill(
        tgt, n, s_src, s_dst, ndev, maxcount,
        amp.ctypes.data_as(ctypes.c_char_p), amp.dtype.itemsize,
        send_src, send_amp.ctypes.data_as(ctypes.c_char_p), dst_idx,
        counts)
    return send_src, send_amp, dst_idx, maxcount


def one_spin_hop_ell(words: np.ndarray, bonds, table: np.ndarray):
    lib = load()
    if lib is None or not bonds:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint64)
    table = np.ascontiguousarray(table, dtype=np.int64)
    bi = np.ascontiguousarray([b[0] for b in bonds], dtype=np.int32)
    bj = np.ascontiguousarray([b[1] for b in bonds], dtype=np.int32)
    t = np.ascontiguousarray([b[2] for b in bonds], dtype=np.float64)
    n = words.shape[0]
    k = len(bonds)
    cols = np.zeros((n, k), dtype=np.int32)
    vals = np.zeros((n, k), dtype=np.float64)
    lib.lpp_one_spin_hop_ell(words, n, bi, bj, t, k, table,
                             table.shape[1], cols, vals)
    return cols, vals
