"""Benchmark: sector-Hamiltonian SpMV throughput (the Lanczos hot loop).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Metric is SpMV nnz/s on a half-filled 14-site Hubbard-chain sector
(BASELINE.json: "SpMV GB/s + nnz/s per chip; Lanczos iterations/sec").
The reference publishes no numbers (BASELINE.md), so vs_baseline
reports the fraction of the card's published HBM bandwidth: bytes
moved per matvec / measured time / peak bandwidth.

Runs in one process on one GPU and fails without one:

    python bench.py
"""

import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from lanczosplusplus_tpu.config import enable_compile_cache

# Published peaks by `device_kind` (NVIDIA H100 SXM data sheet; dense
# rates without sparsity, at the full 700 W power limit).  A device not
# in the table is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
    },
}


def device_peaks(device) -> dict:
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device.device_kind!r}; add them to PEAKS") \
            from None


def card_line() -> str:
    """Name and power limit of the card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def build_hamiltonian(nsite, dtype=np.float32, u=4):
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model

    text = f"""
TotalNumberOfSites={nsite}
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU {nsite} {" ".join([str(u)] * nsite)}
potentialV {2 * nsite} {" ".join(["0"] * 2 * nsite)}
SolverOptions=none
TargetElectronsUp={nsite // 2}
TargetElectronsDown={nsite // 2}
IsPeriodicX=1
"""
    inp = parse_input(text)
    geom = Geometry(inp)
    model = build_model(inp, geom)
    basis = model.create_basis((nsite // 2, nsite // 2))
    return model.hamiltonian(basis, dtype=dtype), basis


def build_tj_factored(nsite, nup, ndn, dtype=np.float32):
    """Block-factorized t-J chain sector (no flat basis needed)."""
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.tj_factored import \
        build_factored_tj_blocks

    term = """DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 {v}
"""
    text = (f"TotalNumberOfSites={nsite}\nNumberOfTerms=4\n"
            + term.format(v=-1.0) + term.format(v=0.3)
            + term.format(v=0.3) + term.format(v=0.0)
            + f"Model=TjMultiOrb\nOrbitals=1\nSolverOptions=none\n"
              f"TargetElectronsUp={nup}\nTargetElectronsDown={ndn}\n"
              "IsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    bk, *_ = build_factored_tj_blocks(model, nup, ndn, dtype=dtype)
    return bk


def build_rashba_blockkron(nsite, ne, dtype=np.float32):
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model

    term = """DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 {v}
"""
    text = (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n"
            + term.format(v=-1.0) + term.format(v=0.5)
            + "Model=HubbardOneBandRashbaSOC\n"
            + f"hubbardU {nsite} {' '.join(['4'] * nsite)}\n"
            + f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
            + "SolverOptions=none\n"
            + f"TargetElectronsTotal={ne}\nIsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(("ne", ne))
    return model.block_kron_hamiltonian(basis, dtype=dtype)


def build_rashba_halfcut(nsite, ne, dtype=np.float32,
                         cross_dtype=None):
    """The production factored form (spatial half-cut): within-half
    Rashba flips run as dense GEMMs; only the cut-crossing bonds stay
    gathers.  Returns the INNER block form — the layout the solvers
    run in (lowest_states/ftlm/kpm unwrap the flat-order adapter)."""
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.rashba_halfcut import \
        build_halfcut_rashba

    term = """DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 {v}
"""
    text = (f"TotalNumberOfSites={nsite}\nNumberOfTerms=2\n"
            + term.format(v=-1.0) + term.format(v=0.5)
            + "Model=HubbardOneBandRashbaSOC\n"
            + f"hubbardU {nsite} {' '.join(['4'] * nsite)}\n"
            + f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
            + "SolverOptions=none\n"
            + f"TargetElectronsTotal={ne}\nIsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(("ne", ne))
    return build_halfcut_rashba(model, basis, dtype=dtype,
                                cross_dtype=cross_dtype).inner


def _time_scanned(ham, iters=32):
    """ms/matvec with `iters` normalized applications inside ONE
    lax.scan dispatch — how the Lanczos hot loop actually runs the
    matvec.  The eager loop above overpays dispatch for many-small-
    block forms (t-J 18-site: 4.1 ms eager vs 2.3 ms scanned)."""
    @jax.jit
    def many(h, x):
        def step(v, _):
            v = h.matvec(v)
            return v / jnp.linalg.norm(v), None
        out, _ = jax.lax.scan(step, x, None, length=iters)
        return out

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (ham.dim,), jnp.float32)
    x = x / jnp.linalg.norm(x)
    y = many(ham, x)
    y.block_until_ready()
    _ = float(y[0])
    t0 = time.perf_counter()
    y = many(ham, y)
    y.block_until_ready()
    _ = float(y[0])
    return (time.perf_counter() - t0) / iters


def _time_stripped(bk_ham, x, iters):
    """ms/matvec of a BlockKronHamiltonian with its PermCrossTerms
    stripped — the GEMM-vs-gather breakdown of the factored sections."""
    import dataclasses
    stripped = dataclasses.replace(bk_ham, perm_cross=())
    mv = jax.jit(lambda h, v: h.matvec(v))
    x = x / jnp.linalg.norm(x)
    y = mv(stripped, x)
    y.block_until_ready()
    _ = float(y[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        x = mv(stripped, x)
    x.block_until_ready()
    _ = float(x[0])
    return (time.perf_counter() - t0) / iters


def _host_f64_oracle(bk_ham, k=1):
    """Independent f64 ground energy: scipy Lanczos over the host
    float64 matvec of the factored form (the same oracle role the
    reference's dense fullDiag plays, DefaultSymmetry.h:80-94)."""
    import scipy.sparse.linalg as spla
    from lanczosplusplus_tpu.ops.df64 import host_matvec_f64

    op = spla.LinearOperator(
        (bk_ham.dim, bk_ham.dim),
        matvec=lambda v: host_matvec_f64(bk_ham, v.astype(np.float64)))
    vals = spla.eigsh(op, k=k, which="SA",
                      return_eigenvectors=False, tol=1e-12)
    return float(np.min(vals))


def build_feas_p33(nsite, nup, ndn, dtype=np.float32, form="flat"):
    """FeAs 2-orbital INT_PAPER33 chain sector — the one production
    Hamiltonian class whose spin-coupled interaction terms (U2
    transverse + U3 pair hopping) live in a generic ELL remainder on
    top of the Kronecker hopping factors (reference hot loop:
    src/Models/FeBasedSc/FeBasedSc.h:52-116).  form="blockkron" builds
    the round-5 single-block BlockKron alternative: dense one-spin hop
    GEMMs + exact (dn ⊗ up) channels instead of the flat ELL."""
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model

    text = (f"TotalNumberOfSites={nsite}\nModel=FeAsBasedSc\n"
            "FeAsMode=INT_PAPER33\nNumberOfTerms=1\n"
            "DegreesOfFreedom=2\nOrbitals=2\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nSolverOptions=none\n"
            "hubbardU 4 4.0 3.0 -0.8 -0.4\n"
            "Connectors 2 2\n-1.0 0.0\n0.0 -1.0\n"
            f"potentialV {4 * nsite} "
            + " ".join(["0"] * (4 * nsite)) + "\n"
            f"TargetElectronsUp={nup}\nTargetElectronsDown={ndn}\n"
            "IsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis((nup, ndn))
    if form == "blockkron":
        return model.block_kron_hamiltonian(basis, dtype=dtype)
    return model.hamiltonian(basis, dtype=dtype)


def build_kitaev_factored(nsite, dtype=np.float32):
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.models.kitaev_factored import \
        build_factored_kitaev

    term = """DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 {v}
"""
    text = (f"TotalNumberOfSites={nsite}\nNumberOfTerms=3\n"
            + term.format(v=1.1) + term.format(v=0.7)
            + term.format(v=0.9)
            + "Model=Kitaev\nSolverOptions=none\nIsPeriodicX=1\n")
    inp = parse_input(text)
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(None)
    return build_factored_kitaev(model, basis, dtype=dtype)


def main():
    device = jax.devices()[0]
    platform = device.platform
    if platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX found {platform}); "
                         "the benchmark measures the card only")
    peaks = device_peaks(device)
    enable_compile_cache()
    print(f"bench: {device.device_kind}; card: {card_line()}",
          file=sys.stderr)
    nsite = 14
    ham, basis = build_hamiltonian(nsite)
    ham = ham.densify_factors()
    dim = ham.dim

    matvec = jax.jit(lambda h, x: h.matvec(x))
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (dim,), jnp.float32)
    x = x / jnp.linalg.norm(x)

    # warmup / compile
    y = matvec(ham, x)
    y.block_until_ready()
    _ = float(y[0])  # force a real device->host sync

    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        x = matvec(ham, x)
    x.block_until_ready()
    dt = (time.perf_counter() - t0) / iters

    nnz = ham.nnz
    nnz_per_s = nnz / dt

    # amortized full Lanczos iteration rate (matvec + 2x full
    # reorthogonalization against a 64-deep Krylov basis, one dispatch
    # for the whole scan)
    from lanczosplusplus_tpu.solver.lanczos import _lanczos_chunk
    steps = 64
    V = jnp.zeros((steps, dim), jnp.float32)
    v = x / jnp.linalg.norm(x)
    # warm up with the same chunk length so the timed call reuses the
    # compiled executable
    V, v, a, b = _lanczos_chunk(ham, V, v, jnp.arange(32))
    jax.block_until_ready(b)
    _ = float(b[0])
    t0 = time.perf_counter()
    V, v, a, b = _lanczos_chunk(ham, V, v, jnp.arange(32, 64))
    jax.block_until_ready(b)
    _ = float(b[-1])
    lanczos_iter_s = 32 / (time.perf_counter() - t0)

    # selective (omega-recurrence) reorthogonalization: full-V passes
    # only when the orthogonality estimate crosses threshold — typical
    # steps cost one matvec (the production default)
    from lanczosplusplus_tpu.solver.lanczos import (
        _lanczos_chunk_selective, _selective_init_state)
    Vs = jnp.zeros((steps, dim), jnp.float32)
    st = _selective_init_state(x / jnp.linalg.norm(x), steps)
    Vs, st, a, b, re = _lanczos_chunk_selective(ham, Vs, st,
                                                jnp.arange(32))
    jax.block_until_ready(b)
    _ = float(b[0])
    t0 = time.perf_counter()
    Vs, st, a, b, re = _lanczos_chunk_selective(ham, Vs, st,
                                                jnp.arange(32, 64))
    jax.block_until_ready(b)
    _ = float(b[-1])
    lanczos_iter_s_sel = 32 / (time.perf_counter() - t0)
    n_reorth_sel = int(np.asarray(re).sum())

    # throughput mode: bfloat16-stored dense factors (native-bf16
    # GEMMs with f32 accumulation; ~4e-3 amplitude quantization).
    # Fresh unit start first: iterated H amplification overflows f32
    # (||x|| is already inf after the timing loop, so renormalizing
    # would produce NaN) and would poison this and later sections.
    x = jax.random.normal(key, (dim,), jnp.float32)
    x = x / jnp.linalg.norm(x)
    ham16 = build_hamiltonian(nsite)[0].densify_factors(
        factor_dtype=jnp.bfloat16)
    y = matvec(ham16, x)
    y.block_until_ready()
    _ = float(y[0])
    t0 = time.perf_counter()
    for _ in range(iters):
        x = matvec(ham16, x)
    x.block_until_ready()
    _ = float(x[0])
    dt16 = (time.perf_counter() - t0) / iters
    # fresh unit start for the Krylov-basis sections (same reason)
    x = jax.random.normal(key, (dim,), jnp.float32)
    x = x / jnp.linalg.norm(x)

    # throughput-oriented config: bfloat16 Krylov basis (halved
    # reorthogonalization traffic, ~1e-3 accuracy)
    Vb = jnp.zeros((steps, dim), jnp.bfloat16)
    vb = x / jnp.linalg.norm(x)
    Vb, vb, a, b = _lanczos_chunk(ham, Vb, vb, jnp.arange(32))
    jax.block_until_ready(b)
    _ = float(b[0])
    t0 = time.perf_counter()
    Vb, vb, a, b = _lanczos_chunk(ham, Vb, vb, jnp.arange(32, 64))
    jax.block_until_ready(b)
    _ = float(b[-1])
    lanczos_iter_s_bf16 = 32 / (time.perf_counter() - t0)

    # selective reorth + bf16 Krylov basis: the V-row store is the
    # dominant non-matvec traffic of a typical (no-reorth) step, so
    # halving it compounds with the selective schedule
    x = jax.random.normal(key, (dim,), jnp.float32)
    x = x / jnp.linalg.norm(x)
    Vsb = jnp.zeros((steps, dim), jnp.bfloat16)
    stb = _selective_init_state(x, steps)
    Vsb, stb, a, b, re = _lanczos_chunk_selective(ham, Vsb, stb,
                                                  jnp.arange(32))
    jax.block_until_ready(b)
    _ = float(b[0])
    t0 = time.perf_counter()
    Vsb, stb, a, b, re = _lanczos_chunk_selective(ham, Vsb, stb,
                                                  jnp.arange(32, 64))
    jax.block_until_ready(b)
    _ = float(b[-1])
    lanczos_iter_s_sel_bf16 = 32 / (time.perf_counter() - t0)

    # free the Krylov-basis buffers of the sections above before the
    # df64/t-J sections allocate theirs
    del V, v, Vb, vb, Vs, st, Vsb, stb, ham16, y
    gc.collect()

    def time_eager(h, repeats=2):
        """min-of-N dependent-chain ms/matvec of the shared jitted
        matvec."""
        best = None
        for _rep in range(repeats):
            xv = jax.random.normal(key, (h.dim,), jnp.float32)
            xv = xv / jnp.linalg.norm(xv)
            yv = matvec(h, xv)
            yv.block_until_ready()
            _ = float(yv[0])
            t0 = time.perf_counter()
            for _ in range(iters):
                xv = matvec(h, xv)
            xv.block_until_ready()
            _ = float(xv[0])
            dtv = (time.perf_counter() - t0) / iters
            best = dtv if best is None else min(best, dtv)
        return best

    # -- t-J sector via the half-cut block factorization --------------
    # (the reference-capability model whose flat path is the generic
    # gather-ELL; the factored form runs the hot loop as GEMMs)
    import dataclasses as _dc
    tj_nsite = 18
    tj_fill = tj_nsite // 2 - 1
    tj_ham = build_tj_factored(tj_nsite, tj_fill, tj_fill)
    dt_tj = time_eager(tj_ham)
    tj_nnz = tj_ham.nnz
    tj_dim = tj_ham.dim
    # cross-term share: time the same form with perm_cross stripped
    # (makes PermCrossTerm regressions visible).
    # Shares are ALSO reported from scanned timings: the scan is the
    # production Lanczos context
    xt = jax.random.normal(key, (tj_ham.dim,), jnp.float32)
    dt_tj_nocross = min(_time_stripped(tj_ham, xt, iters),
                        _time_stripped(tj_ham, xt, iters))
    dt_tj_scan = _time_scanned(tj_ham)
    dt_tj_scan_nocross = _time_scanned(
        _dc.replace(tj_ham, perm_cross=()))

    # -- Rashba SOC sector in block-Kronecker form ---------------------
    # (union basis over (nup, ndown); the flat path is whole-dim
    # gather-ELL, the block form runs hops as per-block GEMMs and
    # the spin flips as partial-permutation gathers)
    del tj_ham, xt
    gc.collect()
    ra_nsite = 13
    ra_ham = build_rashba_halfcut(ra_nsite, ra_nsite)
    dt_ra = time_eager(ra_ham)
    ra_nnz = ra_ham.nnz
    ra_dim = ra_ham.dim
    xr = jax.random.normal(key, (ra_ham.dim,), jnp.float32)
    dt_ra_nocross = min(_time_stripped(ra_ham, xr, iters),
                        _time_stripped(ra_ham, xr, iters))
    dt_ra_scan = _time_scanned(ra_ham)
    dt_ra_scan_nocross = _time_scanned(
        _dc.replace(ra_ham, perm_cross=()))
    del ra_ham, xr
    gc.collect()
    # A/B: bf16 cross-amplitude tables (halve the gather bytes of the
    # PermCrossTerms; RQI refinement recovers exact energies from the
    # unquantized host-f64 residual)
    ra16 = build_rashba_halfcut(ra_nsite, ra_nsite,
                                cross_dtype=jnp.bfloat16)
    dt_ra16 = time_eager(ra16)
    del ra16
    gc.collect()

    # -- FeAs 2-orbital INT_PAPER33 sector: the
    # production Hamiltonian class with a spin-coupled ELL remainder
    # on top of the Kronecker hopping factors --------------------------
    fe_nsite = 8
    fe_ham = build_feas_p33(fe_nsite, fe_nsite // 2,
                            fe_nsite // 2).densify_factors()
    fe_nnz = fe_ham.nnz
    fe_dim = fe_ham.dim
    dt_fe = time_eager(fe_ham)
    dt_fe_scan = _time_scanned(fe_ham)
    # remainder share: same form with the ELL remainder stripped
    fe_kron = _dc.replace(fe_ham, ell=None)
    dt_fe_kron = time_eager(fe_kron)
    del fe_ham, fe_kron
    gc.collect()
    # A/B: the round-5 single-block BlockKron form (dense one-spin hop
    # GEMMs + exact (dn ⊗ up) remainder channels, no flat ELL)
    fe_bk = build_feas_p33(fe_nsite, fe_nsite // 2, fe_nsite // 2,
                           form="blockkron")
    dt_fe_bk = time_eager(fe_bk)
    dt_fe_bk_scan = _time_scanned(fe_bk)
    del fe_bk
    gc.collect()

    # -- translation symmetry on the card: momentum-projected Lanczos
    # over the FULL 2^24 Kitaev chain — T^g is a
    # reshape-transpose on the identity basis, so every sector solve
    # runs at factored-matvec speed with zero gathers ------------------
    from lanczosplusplus_tpu.symmetry.projected import \
        ProjectedTranslationSolver
    from lanczosplusplus_tpu.solver.lanczos import (
        tridiagonalize_plain, tridiag_eigh)
    kit_n = 24
    t0 = time.perf_counter()
    kham24 = build_kitaev_factored(kit_n)
    proj = ProjectedTranslationSolver(kham24, kit_n)
    sym_build_s = time.perf_counter() - t0
    from lanczosplusplus_tpu.solver.lanczos import lowest_states \
        as _ls
    e_plain24, _ = _ls(kham24, max_steps=160)
    # per-k E0: one-pass plain tridiagonalization of P_k H
    steps_k = 160
    e_ks = []
    t0 = time.perf_counter()
    for s in range(proj.sectors()):
        pk = proj.projected(s)
        res = tridiagonalize_plain(pk, proj.start_vector(s),
                                   steps_k)
        ev, _ = tridiag_eigh(res.alphas, res.betas)
        e_ks.append(float(ev[0]))
    t_ks = time.perf_counter() - t0
    kwin = int(np.argmin(e_ks))
    # winner sector: full solve for the vector, purity, refine
    e_win, v_win, _ = proj.solve_sector(kwin,
                                        max_steps=steps_k)
    purity = proj.purity(kwin, v_win[0])
    sym = {
        "sym_model": f"kitaev{kit_n}_translation_projected",
        "sym_dim": kham24.dim,
        "sym_sectors": proj.sectors(),
        "sym_build_s": round(sym_build_s, 2),
        "sym_k_iters_per_s": round(
            proj.sectors() * steps_k / t_ks, 1),
        "sym_min_k": kwin,
        "sym_min_k_e0_rel_err": float(
            f"{abs(float(e_win[0]) - float(e_plain24[0])) / abs(float(e_plain24[0])):.3g}"),
        "sym_winner_purity": float(f"{purity:.6g}"),
    }
    del kham24, proj, v_win
    gc.collect()

    # -- df64 refined-energy accuracy vs exact oracles ----------------
    # (f32 solve + on-chip double-float Rayleigh quotient; the
    # reference is double everywhere, LanczosDriver.h:29-33)
    from lanczosplusplus_tpu.solver.lanczos import lowest_states
    ham_u0 = build_hamiltonian(nsite, u=0)[0].densify_factors()
    e_u0, _ = lowest_states(ham_u0, max_steps=128)
    ks = 2.0 * np.pi * np.arange(nsite) / nsite
    eps = np.sort(-2.0 * np.cos(ks))
    e_exact = 2.0 * eps[:nsite // 2].sum()
    u0_rel_err = abs(float(e_u0[0]) - e_exact) / abs(e_exact)

    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    heis_n = 12
    heis_text = f"""
TotalNumberOfSites={heis_n}
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
TargetSzPlusConst={heis_n // 2}
SolverOptions=none
IsPeriodicX=1
"""
    hinp = parse_input(heis_text)
    hmodel = build_model(hinp, Geometry(hinp))
    hham = hmodel.hamiltonian(hmodel.create_basis(
        hmodel.default_parts(hinp)), dtype=np.float32)
    e_h, _ = lowest_states(hham, max_steps=200)
    heis_exact = -5.387390917445  # Bethe ansatz, N=12 PBC
    heis_rel_err = abs(float(e_h[0]) - heis_exact) / abs(heis_exact)

    # -- refined energies of the FACTORED forms vs f64 oracles --------
    # (factored t-J and Kitaev report
    # <= 1e-10 relative after the host-f64 Rayleigh refinement)
    tj_small = build_tj_factored(10, 4, 4, dtype=np.float32)
    e_tj, _ = lowest_states(tj_small, max_steps=160)
    e_tj_oracle = _host_f64_oracle(tj_small)
    tj_ref_err = abs(float(e_tj[0]) - e_tj_oracle) / abs(e_tj_oracle)
    kit_small = build_kitaev_factored(12, dtype=np.float32)
    e_k, _ = lowest_states(kit_small, max_steps=160)
    e_k_oracle = _host_f64_oracle(kit_small)
    kit_ref_err = abs(float(e_k[0]) - e_k_oracle) / abs(e_k_oracle)
    del tj_small, kit_small
    gc.collect()

    # -- on-chip correctness: production observable pipelines at the
    # chip dtype vs CPU-f64 goldens -----------------------------------
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "benchmarks", "onchip_correctness.py")
    spec = importlib.util.spec_from_file_location(
        "onchip_corr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    correctness = mod.run_onchip(mod.load_goldens())
    gc.collect()

    # bytes moved per matvec: index + value per nnz (int32 + f32 for the
    # factorized maps are amortized over the Kronecker batch, but each
    # gathered x element is a real read) + vector reads/writes
    f = ham.factorized
    index_bytes = 0
    if f is not None:
        for c, v in ((f.up_cols, f.up_vals), (f.dn_cols, f.dn_vals)):
            if c is not None:
                index_bytes += c.size * 4 + v.size * 4
    if ham.ell is not None:
        index_bytes += ham.ell.cols.size * 4 + ham.ell.vals.size * 4
    gathered_reads = 4 * nnz           # each nnz reads one x element
    vector_io = 4 * dim * 3            # x read for diag, y write, diag
    bytes_moved = index_bytes + gathered_reads + vector_io
    gbps = bytes_moved / dt / 1e9

    sol_fraction = (bytes_moved / dt) / peaks["hbm_bytes_per_s"]

    print(json.dumps({
        "metric": "hubbard_sector_spmv_nnz_per_s",
        "value": round(nnz_per_s / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(sol_fraction, 4),
        "detail": {
            "platform": platform,
            "device_kind": device.device_kind,
            "card": card_line(),
            "nsite": nsite,
            "dim": dim,
            "nnz": nnz,
            "ms_per_matvec": round(dt * 1e3, 3),
            "ms_per_matvec_bf16_factors": round(dt16 * 1e3, 3),
            "bf16_factor_gnnz_per_s": round(nnz / dt16 / 1e9, 1),
            "effective_GBps": round(gbps, 1),
            "lanczos_iters_per_s": round(lanczos_iter_s, 2),
            "lanczos_iters_per_s_selective": round(lanczos_iter_s_sel, 2),
            "selective_reorth_steps": n_reorth_sel,
            "lanczos_iters_per_s_bf16V": round(lanczos_iter_s_bf16, 2),
            "lanczos_iters_per_s_selective_bf16V":
                round(lanczos_iter_s_sel_bf16, 2),
            "tj_nsite": tj_nsite,
            "tj_dim": tj_dim,
            "tj_nnz": tj_nnz,
            "tj_ms_per_matvec": round(dt_tj * 1e3, 3),
            "tj_factored_gnnz_per_s": round(tj_nnz / dt_tj / 1e9, 1),
            "tj_ms_gemm_only": round(dt_tj_nocross * 1e3, 3),
            "tj_cross_share": round(1 - dt_tj_nocross / dt_tj, 3),
            "tj_ms_per_matvec_scanned": round(dt_tj_scan * 1e3, 3),
            "tj_ms_gemm_only_scanned":
                round(dt_tj_scan_nocross * 1e3, 3),
            "tj_cross_share_scanned":
                round(1 - dt_tj_scan_nocross / dt_tj_scan, 3),
            "rashba_nsite": ra_nsite,
            "rashba_dim": ra_dim,
            "rashba_nnz": ra_nnz,
            "rashba_form": "halfcut",
            "rashba_ms_per_matvec": round(dt_ra * 1e3, 3),
            "rashba_blockkron_gnnz_per_s":
                round(ra_nnz / dt_ra / 1e9, 1),
            "rashba_ms_gemm_only": round(dt_ra_nocross * 1e3, 3),
            "rashba_cross_share": round(1 - dt_ra_nocross / dt_ra, 3),
            "rashba_ms_per_matvec_scanned":
                round(dt_ra_scan * 1e3, 3),
            "rashba_ms_gemm_only_scanned":
                round(dt_ra_scan_nocross * 1e3, 3),
            "rashba_cross_share_scanned":
                round(1 - dt_ra_scan_nocross / dt_ra_scan, 3),
            "rashba_ms_per_matvec_bf16cross":
                round(dt_ra16 * 1e3, 3),
            "feas_nsite": fe_nsite,
            "feas_dim": fe_dim,
            "feas_nnz": fe_nnz,
            "feas_ms_per_matvec": round(dt_fe * 1e3, 3),
            "feas_gnnz_per_s": round(fe_nnz / dt_fe / 1e9, 1),
            "feas_ms_per_matvec_scanned": round(dt_fe_scan * 1e3, 3),
            "feas_ms_kron_only": round(dt_fe_kron * 1e3, 3),
            "feas_ell_share": round(1 - dt_fe_kron / dt_fe, 3),
            "feas_blockkron_ms": round(dt_fe_bk * 1e3, 3),
            "feas_blockkron_ms_scanned":
                round(dt_fe_bk_scan * 1e3, 3),
            **sym,
            "e0_u0_refined_rel_err": float(f"{u0_rel_err:.3g}"),
            "e0_heisenberg12_refined_rel_err":
                float(f"{heis_rel_err:.3g}"),
            "e0_tj10_factored_refined_rel_err":
                float(f"{tj_ref_err:.3g}"),
            "e0_kitaev12_factored_refined_rel_err":
                float(f"{kit_ref_err:.3g}"),
            **{k: (float(f"{v:.3g}") if isinstance(v, float) else v)
               for k, v in correctness.items()},
        },
    }))


if __name__ == "__main__":
    main()
