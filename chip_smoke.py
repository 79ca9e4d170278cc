"""Bring-up check of the exact-diagonalization engine on one NVIDIA GPU.

    python chip_smoke.py               # one card: phases 1-4
    python chip_smoke.py --four-cards  # four cards: the mesh solve only
    python chip_smoke.py --tf32-report # phase 2 under TF32, no asserts

Phases, in one process (a JAX process reserves most of the card's
memory, so no second one is started):

1. device: a GPU must be present (no CPU fallback); prints the card's
   name and power limit and whether the native host library loaded.
2. small-size correctness at the chip dtype (f32 + refinement) against
   the checked-in f64 goldens (benchmarks/goldens.json).
3. full width through the CLI: a 16-site periodic Hubbard chain at
   half filling (dim 165,636,900) solved by `lanczos_main.run` at U=0
   (checked against the free-fermion value) and U=4 (checked against
   the solve in the other matvec form).
4. one warmed matvec in the gather form and in the dense-factor form,
   at 16 and 14 sites.

The last line of standard output is a JSON object with "ok": true and
the device as JAX reports it; a failed phase exits non-zero before it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (field, bound) of phase 2: f32-plus-refinement bars
CORRECTNESS_BOUNDS = (
    ("e0_input0_rel_err", 1e-9),
    ("e0_input10_rel_err", 1e-9),
    ("e0_input100_rel_err", 1e-9),
    ("e0_input104_rel_err", 1e-9),
    ("gf_tj_max_rel_err", 1e-5),
    ("two_point_max_abs_err", 1e-6),
    ("ftlm_energy_rel_err", 1e-4),
    ("ftlm_log_z_abs_err", 1e-3),
)
E0_REL_TOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """Name and power limit of the card(s), from a child process that
    does not import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def check_device(min_count: int = 1):
    """Phase 1: the accelerator must be a GPU; the package must come
    from this checkout."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found "
                         f"{devices[0].platform}); nothing to check")
    if len(devices) < min_count:
        raise SystemExit(f"chip_smoke: need {min_count} GPUs, found "
                         f"{len(devices)}")
    import lanczosplusplus_tpu
    from lanczosplusplus_tpu import native
    from lanczosplusplus_tpu.config import enable_compile_cache

    pkg = os.path.dirname(os.path.abspath(lanczosplusplus_tpu.__file__))
    if os.path.dirname(pkg) != HERE:
        raise SystemExit(f"chip_smoke: package imported from {pkg}, "
                         f"not from this checkout")
    log(f"device: {devices[0].device_kind} x{len(devices)} "
        f"jax {jax.__version__}")
    log(f"card: {card_line()}")
    log(f"compile cache: {enable_compile_cache()}")
    log(f"native host library: {native.status()}")
    return devices


def phase_correctness(precision: str | None = None) -> dict:
    """Phase 2: production pipelines at the chip dtype vs f64 goldens.
    Returns the fields and the list of bars they break."""
    import jax
    sys.path.insert(0, os.path.join(HERE, "benchmarks"))
    import onchip_correctness as oc

    t0 = time.perf_counter()
    if precision is None:
        out = oc.run_onchip(oc.load_goldens())
    else:
        with jax.default_matmul_precision(precision):
            out = oc.run_onchip(oc.load_goldens())
    broken = [k for k, bound in CORRECTNESS_BOUNDS
              if not out.get(k, np.inf) <= bound]
    log("correctness ({}, {:.1f} s): {}".format(
        precision or "solver precision", time.perf_counter() - t0,
        " ".join(f"{k}={out.get(k)!r}<={b:g}"
                 for k, b in CORRECTNESS_BOUNDS)))
    return {"fields": out, "broken": broken}


def hubbard_input(nsite: int, u: float, periodic: bool = True,
                  steps: int = 200) -> str:
    """Reference-format input of a half-filled one-band Hubbard chain
    (the same sector as bench.py's headline builder)."""
    half = nsite // 2
    return (f"TotalNumberOfSites={nsite}\nNumberOfTerms=1\n"
            "DegreesOfFreedom=1\nGeometryKind=chain\n"
            "GeometryOptions=ConstantValues\nConnectors 1 -1.0\n"
            "Model=HubbardOneBand\n"
            f"hubbardU {nsite} {' '.join([repr(float(u))] * nsite)}\n"
            f"potentialV {2 * nsite} {' '.join(['0'] * 2 * nsite)}\n"
            "SolverOptions=none\n"
            f"LanczosSteps={steps}\n"
            f"TargetElectronsUp={half}\nTargetElectronsDown={half}\n"
            f"IsPeriodicX={int(periodic)}\n")


def free_fermion_e0(nsite: int, nup: int, ndown: int, t: float = -1.0,
                    periodic: bool = True) -> float:
    """U=0 ground energy: filled levels of the one-particle hopping
    matrix (the convention of tests/test_hubbard.py)."""
    h = np.zeros((nsite, nsite))
    for i in range(nsite - 1):
        h[i, i + 1] = h[i + 1, i] = t
    if periodic:
        h[0, nsite - 1] += t
        h[nsite - 1, 0] += t
    eps = np.linalg.eigvalsh(h)
    return float(eps[:nup].sum() + eps[:ndown].sum())


class CompileClock:
    """Sums JAX's tracing, lowering and backend-compile durations."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def relative_residual(ham, vec, e0: float) -> float:
    """||H v - E0 v|| / |E0| of the normalized vector, on the device."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def resid(h, v, e):
        return jnp.linalg.norm(h.matvec(v) - e * v)

    # normalized in its own dispatch: XLA:CPU has been seen to return
    # garbage when the normalization fuses into the matvec's gathers
    v = jnp.asarray(vec)
    v = v / jnp.linalg.norm(v)
    return float(resid(ham, v, e0)) / abs(e0)


def run_cli(path: str, clock: CompileClock) -> dict:
    """Solve one input through the CLI in-process; return E0, the
    engine and the phase times.  `lanczos` and `refine` include any
    compilation that happened inside them; `compile` sums all of it."""
    from lanczosplusplus_tpu.cli import lanczos_main

    c0 = clock.seconds
    t0 = time.perf_counter()
    engine = lanczos_main.run(["-f", path])
    wall = time.perf_counter() - t0
    sec = engine.progress.seconds
    refine_s = engine.solve_info.refine_seconds
    return dict(engine=engine, e0=engine.ground_energy, wall=wall,
                host_build=sec["basis"] + sec["hamiltonian"],
                compile=clock.seconds - c0, refine=refine_s,
                lanczos=sec["diagonalization"] - refine_s)


def phase_cli(outdir: str, nsite: int = 16, steps: int = 200,
              other_form=None) -> dict:
    """Phase 3: the full-width sector through the CLI at U=0 and U=4;
    the U=4 energy is re-solved in the other matvec form."""
    import jax
    from lanczosplusplus_tpu.solver import lanczos as lz

    os.makedirs(outdir, exist_ok=True)
    clock = CompileClock()
    results = {}
    for u in (0.0, 4.0):
        path = os.path.join(outdir, f"hubbard{nsite}_u{u:g}.inp")
        with open(path, "w") as f:
            f.write(hubbard_input(nsite, u, steps=steps))
        r = run_cli(path, clock)
        eng = r.pop("engine")
        ham = eng.hamiltonian
        r["dim"] = int(ham.dim)
        r["residual"] = relative_residual(ham, eng.eigenvector(0), r["e0"])
        if u == 0.0:
            r["expect"] = free_fermion_e0(nsite, nsite // 2, nsite // 2)
            r["rel_err"] = abs(r["e0"] - r["expect"]) / abs(r["expect"])
        else:
            form = other_form or (lambda h: h.densify_factors())
            t0 = time.perf_counter()
            evals, _ = lz.lowest_states(form(ham), seed=eng.config.seed,
                                        max_steps=steps)
            r["other_form_s"] = time.perf_counter() - t0
            r["other_form_e0"] = float(evals[0])
            r["rel_err"] = abs(r["e0"] - r["other_form_e0"]) / abs(r["e0"])
        stats = jax.devices()[0].memory_stats() or {}
        r["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        log(f"cli U={u:g}: dim={r['dim']} E0={r['e0']!r} "
            + (f"expect={r['expect']!r} " if u == 0.0 else
               f"other_form_E0={r['other_form_e0']!r} ")
            + f"rel_err={r['rel_err']:.3e} residual={r['residual']:.3e}")
        log(f"cli U={u:g} times: host_build={r['host_build']:.3f} s "
            f"compile={r['compile']:.3f} s lanczos={r['lanczos']:.3f} s "
            f"refine={r['refine']:.3f} s wall={r['wall']:.3f} s"
            + (f" other_form_solve={r['other_form_s']:.3f} s"
               if u else ""))
        log(f"cli U={u:g} peak_bytes_in_use={r['peak_bytes_in_use']}")
        results[u] = r
        del eng, ham
    return results


def time_matvec(ham, repeats: int = 5) -> float:
    """Median seconds of one jitted, warmed matvec."""
    import jax

    mv = jax.jit(lambda h, v: h.matvec(v))
    x = jax.random.normal(jax.random.PRNGKey(0), (ham.dim,), ham.dtype)
    mv(ham, x).block_until_ready()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        mv(ham, x).block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def phase_matvec_forms(sizes=(16, 14), peaks=None) -> dict:
    """Phase 4: gather form vs dense-factor form (at the solver's
    precision and under TF32) of the Hubbard matvec."""
    import jax
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model

    out = {}
    for nsite in sizes:
        inp = parse_input(hubbard_input(nsite, 4.0))
        model = build_model(inp, Geometry(inp))
        basis = model.create_basis(model.default_parts(inp))
        ham = model.hamiltonian(basis, dtype=np.float32)
        szd, szu = ham.spin_shape
        f = ham.factorized
        gather_s = time_matvec(ham)
        dense = ham.densify_factors()
        dense_s = time_matvec(dense)
        with jax.default_matmul_precision("tensorfloat32"):
            tf32_s = time_matvec(dense)
        flops = 2.0 * szd * szu * (szu + szd)
        nterms = f.up_cols.shape[1] + f.dn_cols.shape[1]
        gather_bytes = 4.0 * ham.dim * (nterms + 3)
        r = dict(dim=int(ham.dim), gather_ms=gather_s * 1e3,
                 dense_ms=dense_s * 1e3, dense_tf32_ms=tf32_s * 1e3,
                 dense_tflops=flops / dense_s / 1e12,
                 dense_tf32_tflops=flops / tf32_s / 1e12,
                 gather_gbps=gather_bytes / gather_s / 1e9)
        line = (f"matvec {nsite} sites dim={r['dim']}: "
                f"gather {r['gather_ms']:.3f} ms "
                f"({r['gather_gbps']:.1f} GB/s of a "
                f"{nterms + 3}-vector byte model), "
                f"dense f32 {r['dense_ms']:.3f} ms "
                f"({r['dense_tflops']:.1f} TFLOP/s), "
                f"dense tf32 {r['dense_tf32_ms']:.3f} ms "
                f"({r['dense_tf32_tflops']:.1f} TFLOP/s)")
        if peaks is not None:
            line += (f"; shares of peak: gather "
                     f"{gather_bytes / gather_s / peaks['hbm_bytes_per_s']:.3f}"
                     f" HBM, dense {flops / dense_s / peaks['f32_flops']:.3f}"
                     f" f32, tf32 {flops / tf32_s / peaks['tf32_flops']:.3f}"
                     f" TF32")
        log(line)
        out[nsite] = r
        del ham, dense
    return out


def refine_on_mesh(ham, vec, mesh) -> float:
    """The one-card solver's energy refinement (df64 residuals + f32
    GMRES corrections, ops/df64.py) run with the flat Hamiltonian and
    the Ritz vector sharded over `mesh`; the distributed solver itself
    returns unrefined f32 Ritz values."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lanczosplusplus_tpu.ops import df64
    from lanczosplusplus_tpu.parallel import mesh as pmesh

    rows = NamedSharding(mesh, P(pmesh.ROWS))
    repl = NamedSharding(mesh, P())
    ham_m = jax.tree_util.tree_map(
        lambda a: jax.device_put(a, rows if a.shape == (ham.dim,)
                                 else repl), ham)
    v = jax.device_put(jnp.asarray(vec, jnp.float32), rows)
    return df64.chip_rqi_refined_energy(ham_m, v)


def phase_four_cards(nsite: int = 16, steps: int = 200, ndev: int = 4):
    """Four cards: the mesh solve of the 16-site sector against the
    one-card solve (U=4) and the free-fermion value (U=0)."""
    import jax
    from lanczosplusplus_tpu.io_.input_parser import parse_input
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.parallel import mesh as pmesh
    from lanczosplusplus_tpu.solver import lanczos as lz

    mesh = pmesh.make_mesh(jax.devices()[:ndev])
    failures = []
    for u in (0.0, 4.0):
        inp = parse_input(hubbard_input(nsite, u, steps=steps))
        model = build_model(inp, Geometry(inp))
        basis = model.create_basis(model.default_parts(inp))
        ham = model.hamiltonian(basis, dtype=np.float32)
        t0 = time.perf_counter()
        e1, _ = lz.lowest_states(ham, max_steps=steps)
        one_s = time.perf_counter() - t0
        e1 = float(e1[0])
        t0 = time.perf_counter()
        e4, vecs, info = pmesh.distributed_lowest_states(
            ham, mesh, max_steps=steps, return_info=True)
        four_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        e4r = refine_on_mesh(ham, vecs[0], mesh)
        refine_s = time.perf_counter() - t0
        ref = free_fermion_e0(nsite, nsite // 2, nsite // 2) \
            if u == 0.0 else e1
        err = abs(e4r - ref) / abs(ref)
        log(f"four cards U={u:g}: dim={ham.dim} E0_4={e4r!r} "
            f"(unrefined {float(e4[0])!r}) E0_1={e1!r} "
            f"reference={ref!r} rel_err={err:.3e} "
            f"time_4={four_s:.3f} s refine_4={refine_s:.3f} s "
            f"time_1={one_s:.3f} s steps={info.steps}")
        if not err <= E0_REL_TOL:
            failures.append(f"U={u:g} rel_err {err:.3e}")
        del ham
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card mesh solve")
    p.add_argument("--tf32-report", action="store_true",
                   help="run phase 2 under TF32 and report the bars it "
                        "breaks, without asserting")
    p.add_argument("--nsite", type=int, default=16,
                   help="chain length of phases 3-4 (a short first "
                        "call on new hardware uses 12)")
    args = p.parse_args(argv)

    devices = check_device(4 if args.four_cards else 1)
    if args.four_cards:
        failures = phase_four_cards(args.nsite)
        if failures:
            raise SystemExit("chip_smoke: four-card solve off: "
                             + "; ".join(failures))
        count = 4
    elif args.tf32_report:
        rep = phase_correctness("tensorfloat32")
        log(f"tf32 breaks: {rep['broken']}")
        return 0
    else:
        from bench import device_peaks

        peaks = device_peaks(devices[0])
        rep = phase_correctness()
        if rep["broken"]:
            raise SystemExit(f"chip_smoke: correctness bars broken: "
                             f"{rep['broken']}")
        cli = phase_cli(os.path.join(HERE, "chiprun_out", "chip_smoke"),
                        args.nsite)
        for u, r in cli.items():
            if not r["rel_err"] <= E0_REL_TOL:
                raise SystemExit(f"chip_smoke: U={u:g} E0 rel_err "
                                 f"{r['rel_err']:.3e} > {E0_REL_TOL}")
        phase_matvec_forms((args.nsite, args.nsite - 2), peaks)
        count = 1
    log(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
