"""End-to-end CLI tests driving the reference TestSuite inputs."""

import os
import sys
sys.path.insert(0, "tests")
import numpy as np
import pytest

from lanczosplusplus_tpu.cli import lanczos_main, ed_main
from reference_inputs import input_path


def test_lanczos_cli_input0(tmp_path, capsys):
    """Run the verbatim reference input0.inp end to end."""
    os.chdir(tmp_path)
    eng = lanczos_main.run(
        ["-f", input_path("input0.inp")])
    out = capsys.readouterr().out
    assert "Energy=" in out
    assert eng.ground_energy == pytest.approx(-2 * np.sqrt(5), abs=1e-9)


def test_lanczos_cli_gf_and_comb(tmp_path, capsys):
    os.chdir(tmp_path)
    eng = lanczos_main.run(
        ["-f", input_path("input0.inp"),
         "-g", "c", "-s", "0,0"])
    # TSPSites absent: no pairs unless DOS; add DOS case:
    text = open(input_path("input0.inp")).read()
    text += "\nComputeDensityOfStates=1\n"
    inp_path = tmp_path / "in_dos.inp"
    inp_path.write_text(text)
    lanczos_main.run(["-f", str(inp_path)])
    combs = sorted(p for p in os.listdir(tmp_path) if p.endswith(".comb"))
    assert len(combs) == 4  # one per site
    from lanczosplusplus_tpu.engine.spectral import read_collection
    coll = read_collection(str(tmp_path / combs[0]))
    assert len(coll.items) == 2  # diagonal: types 0 and 1
    omegas = np.linspace(-15, 15, 3001)
    g = coll.evaluate(omegas, 0.2)
    # DOS integrates to ~1 per site per spin
    total = np.trapezoid(-g.imag / np.pi, omegas)
    assert total == pytest.approx(1.0, abs=0.05)


def test_lanczos_cli_measure_and_cicj(tmp_path, capsys):
    os.chdir(tmp_path)
    eng = lanczos_main.run(
        ["-f", input_path("input0.inp"),
         "-c", "n", "-m", "gs|n[0];n?1[0]|gs", "-r", "2"])
    out = capsys.readouterr().out
    assert "Reduced Density Matrix" in out
    assert "gs|n[0];n?1[0]|gs" in out


def test_measure_matches_double_occupancy(tmp_path):
    """<gs|n_up(0) n_down(0)|gs> via rahul method vs dense."""
    os.chdir(tmp_path)
    eng = lanczos_main.run(
        ["-f", input_path("input0.inp")])
    val = eng.measure("gs|n[0];n?1[0]|gs")
    gs = np.asarray(eng.eigenvector(0))
    from lanczosplusplus_tpu.core import bits as B
    idx = np.arange(eng.basis.size)
    nu = B.get_bit(eng.basis.words_up(idx), 0)
    nd = B.get_bit(eng.basis.words_down(idx), 0)
    expect = float(np.sum(np.abs(gs) ** 2 * nu * nd))
    assert val.real == pytest.approx(expect, abs=1e-10)


def test_ed_cli(tmp_path, capsys):
    text = open(input_path("input0.inp")).read()
    text += ("\nTemperatureOrBeta=beta\nTemperatureOrBetaStart=0.5\n"
             "TemperatureOrBetaTotal=3\nTemperatureOrBetaStep=1.0\n")
    inp_path = tmp_path / "ed.inp"
    inp_path.write_text(text)
    ed = ed_main.run(["-f", str(inp_path)])
    out = capsys.readouterr().out
    assert "#tb=beta" in out
    assert len(out.strip().splitlines()) == 5


def test_input10_dumpmatrix_full_spectrum(tmp_path, capsys):
    """input10.inp verbatim: dumpmatrix prints the full spectrum, which
    must equal the analytic Rashba dispersion."""
    os.chdir(tmp_path)
    eng = lanczos_main.run(
        ["-f", input_path("input10.inp")])
    out = capsys.readouterr().out
    assert "#FullSpectrum" in out
    lines = out.split("#FullSpectrum")[1].strip().splitlines()
    evals = np.array([float(x) for x in lines[:8]])
    from test_rashba import dispersion_oracle
    np.testing.assert_allclose(np.sort(evals),
                               dispersion_oracle(4, -1.0, 7.0),
                               atol=1e-9)


def test_thermal_cli(tmp_path, capsys):
    from lanczosplusplus_tpu.cli import thermal_main
    gc = thermal_main.run(
        ["-f", input_path("input0.inp"),
         "-c", "c", "-b", "1.5", "-s", "0", "-m", "0.5"])
    err = capsys.readouterr().err
    assert "density=" in err and "energy=" in err


def test_sqomega_cli(tmp_path, capsys):
    from lanczosplusplus_tpu.cli import sqomega_main
    import sys
    sys.path.insert(0, "tests")
    text = open(input_path("input0.inp")).read()
    path = tmp_path / "sq.inp"
    path.write_text(text)
    out = sqomega_main.run(["-f", str(path), "-g", "sz",
                            "-b", "-3", "-e", "3", "-s", "0.5",
                            "-d", "0.1"])
    cap = capsys.readouterr().out
    assert len(cap.strip().splitlines()) == 13


def test_input100_and_104_end_to_end(tmp_path, capsys):
    """The two FeAs TestSuite inputs run verbatim; input104 differs by
    AnisotropyD and must shift the ground-state energy."""
    os.chdir(tmp_path)
    eng100 = lanczos_main.run(
        ["-f", input_path("input100.inp")])
    eng104 = lanczos_main.run(
        ["-f", input_path("input104.inp")])
    # regression goldens (established by this framework; the C++
    # reference is unbuildable here — see BASELINE.md)
    assert eng100.ground_energy == pytest.approx(-3.099464014219,
                                                 abs=1e-8)
    assert eng104.ground_energy == pytest.approx(4.205534707006,
                                                 abs=1e-8)


def test_consistency_cli(capsys):
    from lanczosplusplus_tpu.cli import consistency_main
    e = consistency_main.run(
        ["-f", input_path("input0.inp"), "--tinf"])
    out = capsys.readouterr().out
    assert "Lanczos: lowest eigenvalue=" in out
    assert "Lapack: lowest eigenvalue=" in out
    assert "T=infinity energy=" in out
    # T=inf energy for U=0 trace is 0 (hopping is traceless)
    tinf = float(out.split("T=infinity energy=")[1].strip().split()[0])
    assert abs(tinf) < 1e-10


def test_excited_state_braket_measure(tmp_path):
    os.chdir(tmp_path)
    text = open(input_path("input0.inp")).read()
    text += "\nExcited=1\n"
    path = tmp_path / "exc.inp"
    path.write_text(text)
    eng = lanczos_main.run(["-f", str(path)])
    # <P1|n[0]|P1> matches the dense first-excited state occupation
    val = eng.measure("P1|n[0]|P1").real
    dense = eng.hamiltonian.to_dense()
    evals, evecs = np.linalg.eigh(dense)
    from lanczosplusplus_tpu.core import bits as B
    idx = np.arange(eng.basis.size)
    occ = B.get_bit(eng.basis.words_up(idx), 0)
    # degenerate subspaces make single-vector comparison ambiguous;
    # check the value lies within the degenerate subspace's range
    e1 = eng.energies(1)
    degset = np.nonzero(np.abs(evals - e1) < 1e-8)[0]
    vals = []
    for k in degset:
        v = evecs[:, k]
        vals.append(float(np.sum(np.abs(v) ** 2 * occ)))
    assert min(vals) - 1e-6 <= val <= max(vals) + 1e-6


def test_qpz_cli(capsys):
    from lanczosplusplus_tpu.cli import qpz_main
    out = qpz_main.run(
        ["-f", input_path("input0.inp"), "--ratio"])
    assert len(out) == 4
    cap = capsys.readouterr().out
    assert len(cap.strip().splitlines()) == 4


def test_dynamics1_cli(tmp_path, capsys):
    from lanczosplusplus_tpu.cli import dynamics1_main
    text = open(input_path("input100.inp")).read()
    text = text.replace("TotalNumberOfSites=6", "TotalNumberOfSites=2") \
        .replace("potentialV 24", "potentialV 8") \
        .replace("4.10 4.10 4.10 4.10 4.10 4.10", "0 0") \
        .replace("0.0 0.0 0.0 0.0 0.0 0.0", "0 0") \
        .replace("TargetElectronsUp=3", "TargetElectronsUp=1") \
        .replace("TargetElectronsDown=3", "TargetElectronsDown=1")
    path = tmp_path / "d1.inp"
    path.write_text(text)
    cf = dynamics1_main.run(["-f", str(path), "-r", "1"])
    cap = capsys.readouterr().out
    assert "SPECTRAL" in cap and "#Avector" in cap
    assert cf.weight >= 0
