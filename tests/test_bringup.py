"""What the GPU bring-up added, checked on the CPU: the compile-cache
helper, the matmul-precision policy, the device-derived Krylov budget,
the native loader's status, bench.py's peaks table and chip_smoke.py's
phases at a tiny size."""

import math
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lanczosplusplus_tpu import config, native
from lanczosplusplus_tpu.engine import Engine
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.io_.input_check import validate_input
from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.solver import lanczos as lz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.fixture
def cache_dir_config():
    """Restore jax_compilation_cache_dir after a test changes it."""
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_uses_env_and_sets_nothing(monkeypatch, tmp_path,
                                                 cache_dir_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert config.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_path_in_checkout(monkeypatch,
                                              cache_dir_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert config.enable_compile_cache() == path      # never moves


def _hubbard(nsite, u=4.0, dtype=np.float64):
    inp = parse_input(chip_smoke.hubbard_input(nsite, u))
    model = build_model(inp, Geometry(inp))
    basis = model.create_basis(model.default_parts(inp))
    return model.hamiltonian(basis, dtype=dtype)


def _lowered(fn, *args):
    return jax.jit(fn).lower(*args).as_text()


def _gemm_cases():
    ham = _hubbard(6).densify_factors()
    x = jnp.ones(ham.dim)
    V = jnp.ones((4, ham.dim))
    return {
        "dense_factor_matvec": (lambda h, v: h.matvec(v), ham, x),
        "dense_factor_matmat_t": (lambda h, v: h.matmat_t(v), ham, V),
        "reorthogonalization": (lz._reorth_pass, V, x),
    }


@pytest.mark.parametrize("case", ["dense_factor_matvec",
                                  "dense_factor_matmat_t",
                                  "reorthogonalization"])
def test_precision_policy_reaches_solver_gemms(case):
    fn, *args = _gemm_cases()[case]
    text = _lowered(fn, *args)
    assert "dot_general" in text
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots)


def test_precision_policy_follows_caller_scope():
    fn, *args = _gemm_cases()["dense_factor_matvec"]
    with jax.default_matmul_precision("tensorfloat32"):
        assert config.matmul_precision() == "tensorfloat32"
        text = _lowered(fn, *args)
    assert "HIGHEST" not in text
    assert config.matmul_precision() == "highest"


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats, expect", [
    ({"bytes_limit": 63763120128}, int(0.5 * 63763120128)),
    ({"bytes_in_use": 0}, 6 << 30),
    (None, 6 << 30),
])
def test_krylov_budget_from_device(stats, expect):
    assert lz.default_krylov_budget_bytes(_FakeDevice(stats)) == expect


def test_lowest_states_takes_the_device_budget(monkeypatch):
    """A budget too small for the stored basis switches lowest_states
    to the plain two-pass solver (no residual estimate: nan)."""
    ham = _hubbard(6)
    _, _, info = lz.lowest_states(ham, return_info=True, max_steps=60)
    assert not math.isnan(info.residual)
    monkeypatch.setattr(lz, "default_krylov_budget_bytes", lambda: 1024)
    e_plain, _, info = lz.lowest_states(ham, return_info=True,
                                        max_steps=60)
    assert math.isnan(info.residual)
    dense = np.linalg.eigvalsh(ham.to_dense())[0]
    assert e_plain[0] == pytest.approx(dense, abs=1e-9)


def test_engine_keeps_gather_form_and_times_phases():
    inp = parse_input(chip_smoke.hubbard_input(6, 4.0))
    eng = Engine(build_model(inp, Geometry(inp)), inp)
    f = eng.hamiltonian.factorized
    assert f.up_dense is None and f.dn_dense is None
    assert {"basis", "hamiltonian", "diagonalization"} \
        <= set(eng.progress.seconds)
    assert eng.solve_info.refine_seconds >= 0.0


def test_native_status_reports_library():
    assert native.status().startswith(("loaded ", "numpy fallback ("))
    assert native.available() == native.status().startswith("loaded ")


def test_native_status_reports_failed_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_repo_root", lambda: str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_STATUS", "not loaded yet")
    assert native.load() is None
    assert native.status().startswith("numpy fallback (")


def test_bench_peaks_table():
    class Kind:
        device_kind = "NVIDIA H100 80GB HBM3"
    assert bench.device_peaks(Kind())["hbm_bytes_per_s"] == 3.35e12
    Kind.device_kind = "some other card"
    with pytest.raises(KeyError, match="some other card"):
        bench.device_peaks(Kind())


@pytest.mark.parametrize("entry", [bench.main, chip_smoke.check_device])
def test_entry_points_refuse_the_cpu(entry):
    with pytest.raises(SystemExit, match="no GPU"):
        entry()


def test_chip_smoke_alone_fails_without_ok_line(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("nsite", [6, 8])
def test_free_fermion_value_matches_engine(nsite):
    inp = parse_input(chip_smoke.hubbard_input(nsite, 0.0))
    assert validate_input(inp)
    eng = Engine(build_model(inp, Geometry(inp)), inp)
    expect = chip_smoke.free_fermion_e0(nsite, nsite // 2, nsite // 2)
    assert eng.ground_energy == pytest.approx(expect, abs=1e-10)


def test_chip_smoke_cli_phase_small(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = chip_smoke.phase_cli(str(tmp_path / "out"), nsite=8)
    assert res[0.0]["dim"] == 4900
    assert res[0.0]["rel_err"] < 1e-10
    assert res[4.0]["rel_err"] < 1e-10
    for r in res.values():
        assert r["residual"] < 1e-6
        assert r["host_build"] >= 0 and r["lanczos"] >= 0


def test_chip_smoke_matvec_phase_small():
    out = chip_smoke.phase_matvec_forms((6,))
    r = out[6]
    assert r["dim"] == 400
    assert min(r["gather_ms"], r["dense_ms"], r["dense_tf32_ms"]) > 0


def test_chip_smoke_correctness_bounds_cover_goldens():
    fields = {k for k, _ in chip_smoke.CORRECTNESS_BOUNDS}
    assert {"e0_input0_rel_err", "e0_input104_rel_err",
            "gf_tj_max_rel_err", "ftlm_log_z_abs_err"} <= fields


@pytest.fixture
def gpu_device():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {device.platform}")
    return device


@pytest.mark.gpu
def test_cli_phase_on_card(gpu_device, tmp_path, monkeypatch):
    """The CLI phase at 12 sites (dim 853,776) in f32 on the card."""
    monkeypatch.chdir(tmp_path)
    res = chip_smoke.phase_cli(str(tmp_path / "out"), nsite=12)
    assert res[0.0]["rel_err"] < chip_smoke.E0_REL_TOL
    assert res[4.0]["rel_err"] < chip_smoke.E0_REL_TOL
