"""Double-float (df64) arithmetic on the device: f32 (hi, lo) pairs.

The solver runs in float32; the reference is double everywhere
(reference: src/Engine/LanczosDriver.h:29-33).  This module emulates
~2x-f32 precision (unit roundoff ~2^-48) with error-free
transformations (Dekker/Knuth two_sum/two_prod; the split-based
two_prod needs no FMA, so XLA's elementwise lowering preserves
exactness — XLA does not contract or reassociate elementwise float
ops).

The production use is `refined_energy`: the Lanczos solve runs in f32
(full GEMM speed), then ONE df64 Hamiltonian application + df64 dot
evaluates the Rayleigh quotient rho(v) = <v|H|v>/<v|v> exactly enough
(~1e-13) that the energy error is dominated by the QUADRATIC term
O(||dv||^2) of the eigenvector error — f32 Lanczos residuals of ~1e-6
yield energies at ~1e-12 relative, matching the reference's f64 bar at
a tiny fraction of an f64-emulated solve.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from lanczosplusplus_tpu.config import matmul_precision


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth; no ordering assumption)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Veltkamp split of f32 into 12-bit-significand halves."""
    c = a * jnp.float32(4097.0)    # 2^12 + 1
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e (Dekker, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl) -> normalized df64."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return fast_two_sum(sh, te)


def df_add_f32(xh, xl, y):
    sh, se = two_sum(xh, y)
    return fast_two_sum(sh, xl + se)


def df_prod_f32(a, b):
    """f32 * f32 -> df64 (exact)."""
    return two_prod(a, b)


def df_sum_pairwise(xh, xl):
    """df64 sum of a (n,) df64 array by pairwise folding (log2(n)
    df_adds over halves; error ~ log2(n) * 2^-48)."""
    n = xh.shape[0]
    m = 1 << int(np.ceil(np.log2(max(n, 1))))
    xh = jnp.pad(xh, (0, m - n))
    xl = jnp.pad(xl, (0, m - n))
    while m > 1:
        m //= 2
        xh, xl = df_add(xh[:m], xl[:m], xh[m:], xl[m:])
    return xh[0], xl[0]


def _df64_apply(ham, v):
    """(yh, yl) = H v in df64: diag + generic ELL + Kronecker gather
    factors (the dense-GEMM forms are bypassed — gathers keep every
    product error-free)."""
    yh, yl = two_prod(ham.diag.astype(jnp.float32), v)
    if ham.factorized is not None:
        f = ham.factorized
        szd, szu = ham.spin_shape
        x2d = v.reshape(szd, szu)
        y2h = yh.reshape(szd, szu)
        y2l = yl.reshape(szd, szu)
        if f.up_cols is not None:
            for k in range(f.up_cols.shape[1]):
                ph, pl = two_prod(
                    jnp.broadcast_to(f.up_vals[None, :, k], (szd, szu)),
                    x2d[:, f.up_cols[:, k]])
                y2h, y2l = df_add(y2h, y2l, ph, pl)
        if f.dn_cols is not None:
            for k in range(f.dn_cols.shape[1]):
                ph, pl = two_prod(
                    jnp.broadcast_to(f.dn_vals[:, k, None], (szd, szu)),
                    x2d[f.dn_cols[:, k], :])
                y2h, y2l = df_add(y2h, y2l, ph, pl)
        yh = y2h.reshape(-1)
        yl = y2l.reshape(-1)
    if ham.ell is not None:
        for k in range(ham.ell.cols.shape[1]):
            ph, pl = two_prod(ham.ell.vals[:, k], v[ham.ell.cols[:, k]])
            yh, yl = df_add(yh, yl, ph, pl)
    return yh, yl


@jax.jit
def _rayleigh_df64(ham, v):
    v = v.astype(jnp.float32)
    yh, yl = _df64_apply(ham, v)
    # numerator sum_i v_i y_i in df64
    nh, nl = two_prod(v, yh)
    nh, nl = df_add(nh, nl, v * yl, jnp.zeros_like(v))
    num_h, num_l = df_sum_pairwise(nh, nl)
    dh, dl = two_prod(v, v)
    den_h, den_l = df_sum_pairwise(dh, dl)
    return num_h, num_l, den_h, den_l


def refined_energy(ham, v) -> float:
    """<v|H|v> / <v|v> evaluated in on-chip df64 for a REAL f32
    Hamiltonian/state.  For a Ritz vector from the f32 Lanczos solve
    this recovers the energy to ~1e-12 relative (quadratic eigenvector
    error), matching the f64 reference bar without an f64 solve.
    Returns a Python float (f64 recombination on host)."""
    if jnp.issubdtype(jnp.dtype(getattr(v, "dtype", np.float64)),
                      jnp.complexfloating):
        raise NotImplementedError("df64 refinement: real states only")
    num_h, num_l, den_h, den_l = _rayleigh_df64(ham, jnp.asarray(v))
    num = float(np.float64(np.asarray(num_h))
                + np.float64(np.asarray(num_l)))
    den = float(np.float64(np.asarray(den_h))
                + np.float64(np.asarray(den_l)))
    return num / den


# ---------------------------------------------------------------------------
# Host float64 Rayleigh refinement for the forms the on-chip df64 apply
# cannot cover: block-Kronecker / permuted factored Hamiltonians (their
# hot op is a GEMM, which rounds its accumulation — there is
# no error-free-transformation route through it) and complex scalars.
# One f64 matvec-worth of numpy work, off the hot path, gives the exact
# same f64 bar (reference: src/Engine/LanczosDriver.h:29-33 RealType =
# double).

def _np64(a, ctype):
    return np.asarray(a).astype(ctype)


def _host_matvec_blockkron(ham, xs, ctype):
    """Numpy float64/complex128 mirror of BlockKronHamiltonian.matvec
    (core/blockkron.py) on pre-split per-block matrices xs."""
    ys = [_np64(ham.diag[b], ctype) * xs[b] for b in range(len(xs))]
    for b in range(len(xs)):
        if ham.row_ops[b] is not None:
            ys[b] = ys[b] + _np64(ham.row_ops[b], ctype) @ xs[b]
        if ham.col_ops[b] is not None:
            ys[b] = ys[b] + xs[b] @ _np64(ham.col_ops[b], ctype).T
    for t in ham.cross:
        left = _np64(t.left, ctype)
        right = _np64(t.right, ctype)
        t1 = np.einsum("ndc,rc->nrd", right, xs[t.src])
        ys[t.dst] = ys[t.dst] + np.einsum("nor,nrd->od", left, t1)
        if t.add_hc:
            t2 = np.einsum("rd,ndc->nrc", xs[t.dst], np.conj(right))
            ys[t.src] = ys[t.src] + np.einsum("nor,noc->rc",
                                              np.conj(left), t2)
    for t in ham.perm_cross:
        x = xs[t.src]
        row_src = np.asarray(t.row_src)
        col_src = np.asarray(t.col_src)
        row_amp = _np64(t.row_amp, ctype)
        col_amp = _np64(t.col_amp, ctype)
        for n in range(row_src.shape[0]):
            rows = x[row_src[n]]
            ys[t.dst] = ys[t.dst] + (row_amp[n][:, None]
                                     * rows[:, col_src[n]]
                                     * col_amp[n][None, :])
    return ys


def host_matvec_f64(ham, v) -> np.ndarray:
    """H @ v on the HOST in float64/complex128 for any Hamiltonian form
    (flat diag/ELL/Kronecker gather, BlockKronHamiltonian,
    PermutedHamiltonian)."""
    cplx = (jnp.issubdtype(jnp.dtype(getattr(v, "dtype", np.float64)),
                           jnp.complexfloating) or
            jnp.issubdtype(jnp.dtype(ham.dtype), jnp.complexfloating))
    ctype = np.complex128 if cplx else np.float64
    x = _np64(v, ctype)
    if hasattr(ham, "inner"):           # PermutedHamiltonian
        perm = np.asarray(ham.perm)
        inv = np.asarray(ham.inv)
        xp = x[perm]
        if getattr(ham, "sign", None) is not None:
            s = _np64(ham.sign, ctype)
            return (s * host_matvec_f64(ham.inner, s * xp))[inv]
        return host_matvec_f64(ham.inner, xp)[inv]
    if hasattr(ham, "shapes"):          # BlockKronHamiltonian
        xs = []
        off = 0
        for (r, c) in ham.shapes:
            xs.append(x[off:off + r * c].reshape(r, c))
            off += r * c
        ys = _host_matvec_blockkron(ham, xs, ctype)
        return np.concatenate([y.reshape(-1) for y in ys])
    if hasattr(ham, "hr_t"):            # FactoredKitaevHamiltonian
        dl, dr = ham.diag2d.shape
        xm = x.reshape(dl, dr)
        y = _np64(ham.diag2d, ctype) * xm
        y = y + _np64(ham.hl, ctype) @ xm
        y = y + xm @ _np64(ham.hr_t, ctype)
        if ham.p.shape[0]:
            px = np.einsum("kab,bd->kad", _np64(ham.p, ctype), xm)
            y = y + np.einsum("kad,kcd->ac", px, _np64(ham.q, ctype))
        return y.reshape(-1)
    # flat Hamiltonian: always via the gather maps (kept alongside the
    # densified factors; exact in f64)
    y = _np64(ham.diag, ctype) * x
    if getattr(ham, "factorized", None) is not None:
        f = ham.factorized
        szd, szu = ham.spin_shape
        x2d = x.reshape(szd, szu)
        y2 = y.reshape(szd, szu)
        if f.up_cols is not None:
            cu = np.asarray(f.up_cols)
            vu = _np64(f.up_vals, ctype)
            for k in range(cu.shape[1]):
                y2 = y2 + vu[None, :, k] * x2d[:, cu[:, k]]
        if f.dn_cols is not None:
            cd = np.asarray(f.dn_cols)
            vd = _np64(f.dn_vals, ctype)
            for k in range(cd.shape[1]):
                y2 = y2 + vd[:, k, None] * x2d[cd[:, k], :]
        y = y2.reshape(-1)
    if getattr(ham, "ell", None) is not None:
        cols = np.asarray(ham.ell.cols)
        vals = _np64(ham.ell.vals, ctype)
        for k in range(cols.shape[1]):
            y = y + vals[:, k] * x[cols[:, k]]
    return y


def refinement_flops(ham) -> float:
    """Rough flop count of one host_matvec_f64, used to cap the
    automatic refinement at dims where the one-shot host pass would
    take minutes."""
    if hasattr(ham, "inner"):
        return refinement_flops(ham.inner)
    if hasattr(ham, "shapes"):
        n = 0.0
        for b, (r, c) in enumerate(ham.shapes):
            n += r * c
            if ham.row_ops[b] is not None:
                n += 2.0 * r * r * c
            if ham.col_ops[b] is not None:
                n += 2.0 * r * c * c
        for t in ham.cross:
            nb, rd, rs = t.left.shape
            cd, cs = t.right.shape[1:]
            n += 2.0 * nb * (rd * rs * cs + rd * cs * cd)
            if t.add_hc:
                n += 2.0 * nb * (rd * cd * cs + rd * rs * cs)
        for t in ham.perm_cross:
            n += 3.0 * t.row_src.shape[0] * t.row_src.shape[1] \
                * t.col_src.shape[1]
        return n
    if hasattr(ham, "hr_t"):            # FactoredKitaevHamiltonian
        dl, dr = ham.diag2d.shape
        k = int(ham.p.shape[0])
        return float(dl * dr + 2.0 * (1 + k) * dl * dr * (dl + dr))
    n = 2.0 * ham.dim
    if getattr(ham, "factorized", None) is not None:
        f = ham.factorized
        szd, szu = ham.spin_shape
        if f.up_cols is not None:
            n += 2.0 * szd * np.prod(f.up_cols.shape)
        if f.dn_cols is not None:
            n += 2.0 * szu * np.prod(f.dn_cols.shape)
    if getattr(ham, "ell", None) is not None:
        n += 2.0 * np.prod(ham.ell.cols.shape)
    return float(n)


def host_refined_energy(ham, v) -> float:
    """<v|H|v> / <v|v> in host float64/complex128 — the refinement path
    for factored block forms and complex scalars (chip df64 covers the
    real flat forms)."""
    y = host_matvec_f64(ham, v)
    cplx = np.iscomplexobj(y)
    x = _np64(v, np.complex128 if cplx else np.float64)
    return float(np.real(np.vdot(x, y)) / np.real(np.vdot(x, x)))


# ---------------------------------------------------------------------------
# Mixed-precision Rayleigh-quotient iteration.
#
# A single Rayleigh quotient of an f32 Ritz vector can only SQUARE the
# f32 vector error (~1e-3 -> ~1e-6 relative energy) — it cannot reach
# the reference's f64 bar (src/Engine/LanczosDriver.h:29-33).  These
# routines run 2-3 refinement steps of the classic mixed-precision
# scheme: compute the residual r = Hv - theta*v in HIGH precision
# (host f64 matvec for factored block forms, the on-chip df64
# error-free apply for flat real forms), then solve the correction
# equation (H - theta) t ~= r CHEAPLY in f32 on the device (GMRES over
# the production matvec), update v <- v - t in high precision.  The
# vector error contracts by the inner-solve accuracy each step, so the
# Rayleigh quotient lands at 1e-12..1e-14 relative after 2 steps.
# Both r and t are projected orthogonal to v: (H - theta) is nearly
# singular along v, and any v-component of the right-hand side (e.g.
# from rounding theta to f32) would otherwise be amplified by
# 1/|lambda_min|.

@lru_cache(maxsize=None)
def _gmres_solver(restart, maxiter):
    from jax.scipy.sparse.linalg import gmres

    @jax.jit
    def _solve(h, rr, th):
        def A(x):
            return h.matvec(x) - th * x
        t, _ = gmres(A, rr, tol=1e-4, atol=0.0, restart=restart,
                     maxiter=maxiter, solve_method="batched")
        return t

    return _solve


def _gmres_correct(ham, r, theta, restart=20, maxiter=3):
    """Approximate (H - theta I)^{-1} r on the device in the
    Hamiltonian's native (f32/c64) precision."""
    return _gmres_solver(restart, maxiter)(ham, r, theta)


def rqi_refined_energy(ham, v, iters: int = 2, restart: int = 20,
                       maxiter: int = 3) -> float:
    """Rayleigh-quotient iteration with host-f64 residuals and device
    f32/c64 correction solves, for the Hamiltonian forms whose hot op
    is a GEMM (block-Kronecker / permuted factored forms, complex
    scalars) where no on-chip error-free-transformation route exists.
    Costs iters+1 host f64 matvecs + iters cheap device GMRES solves."""
    cplx = (jnp.issubdtype(jnp.dtype(getattr(v, "dtype", np.float64)),
                           jnp.complexfloating) or
            jnp.issubdtype(jnp.dtype(ham.dtype), jnp.complexfloating))
    ctype = np.complex128 if cplx else np.float64
    dt = jnp.dtype(ham.dtype)
    x = _np64(v, ctype)
    x = x / np.linalg.norm(x)
    theta = None
    for _ in range(iters):
        y = host_matvec_f64(ham, x)
        theta = float(np.real(np.vdot(x, y)))
        r = y - theta * x
        r = r - np.vdot(x, r) * x
        if np.linalg.norm(r) <= 1e-13 * max(1.0, abs(theta)):
            return theta
        t = np.asarray(_gmres_correct(
            ham, jnp.asarray(r.astype(dt)),
            jnp.asarray(np.asarray(theta).astype(dt)),
            restart=restart,
            maxiter=maxiter)).astype(ctype)
        t = t - np.vdot(x, t) * x
        xn = x - t
        nn = np.linalg.norm(xn)
        if not np.isfinite(nn) or nn == 0.0:
            break      # GMRES breakdown: keep the last finite iterate
        x = xn / nn
    y = host_matvec_f64(ham, x)
    return float(np.real(np.vdot(x, y)) / np.real(np.vdot(x, x)))


@jax.jit
def _df64_resid_parts(ham, x):
    """One df64 apply + the df64 Rayleigh dots (shared by the chip RQI
    loop and the final quotient)."""
    yh, yl = _df64_apply(ham, x)
    nh, nl = two_prod(x, yh)
    nh, nl = df_add(nh, nl, x * yl, jnp.zeros_like(x))
    num_h, num_l = df_sum_pairwise(nh, nl)
    dh, dl = two_prod(x, x)
    den_h, den_l = df_sum_pairwise(dh, dl)
    return yh, yl, num_h, num_l, den_h, den_l


@jax.jit
def _df64_residual_vec(x, yh, yl, theta):
    """r = (y - theta x) computed in df64 then rounded to f32, with the
    v-component projected out (see module comment)."""
    ph, pl = two_prod(theta, x)
    rh, rl = df_add(yh, yl, -ph, -pl)
    r = rh + rl
    return r - jnp.dot(x, r, precision=matmul_precision()) * x


@jax.jit
def _apply_correction(x, t):
    t = t - jnp.dot(x, t, precision=matmul_precision()) * x
    xn = x - t
    return xn / jnp.linalg.norm(xn)


def chip_rqi_refined_energy(ham, v, iters: int = 2, restart: int = 20,
                            maxiter: int = 3) -> float:
    """On-chip RQI for REAL f32 flat Hamiltonians: residual and
    Rayleigh quotient via the df64 error-free apply over the gather
    maps, correction solve in f32 GMRES over the production (dense-
    factor) matvec.  No host matvec at any dimension — this lifts the
    flop-budget cap that limited the large flat-form refinement to a
    single quotient."""
    if jnp.issubdtype(jnp.dtype(getattr(v, "dtype", np.float64)),
                      jnp.complexfloating):
        raise NotImplementedError("df64 refinement: real states only")
    x = jnp.asarray(v, jnp.float32)
    x = x / jnp.linalg.norm(x)
    theta = 0.0
    for it in range(iters + 1):
        yh, yl, nh, nl, dh, dl = _df64_resid_parts(ham, x)
        num = (np.float64(np.asarray(nh)) + np.float64(np.asarray(nl)))
        den = (np.float64(np.asarray(dh)) + np.float64(np.asarray(dl)))
        theta = float(num / den)
        if it == iters:
            break
        th32 = jnp.asarray(theta, jnp.float32)
        r = _df64_residual_vec(x, yh, yl, th32)
        if float(jnp.linalg.norm(r)) <= 1e-12 * max(1.0, abs(theta)):
            break
        t = _gmres_correct(ham, r, th32, restart=restart,
                           maxiter=maxiter)
        if not bool(jnp.isfinite(jnp.linalg.norm(t))):
            # GMRES breakdown (NaN) — near-degenerate theta makes
            # (H - theta) nearly singular; a short solve amplifies less
            t = _gmres_correct(ham, r, th32, restart=8, maxiter=1)
        xn = _apply_correction(x, t)
        # keep the last finite iterate — its quotient is still at
        # least the plain df64 Rayleigh refinement
        if not bool(jnp.isfinite(jnp.linalg.norm(xn))):
            break
        x = xn
    return theta
