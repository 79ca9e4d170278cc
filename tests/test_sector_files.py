"""Sector-file artifact round-trip + thermal consistency."""

import numpy as np
import pytest

from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.geometry import Geometry
from lanczosplusplus_tpu.models import build_model
from lanczosplusplus_tpu.io_ import sector_files
from reference_inputs import input_path


def test_roundtrip_and_partition(tmp_path):
    inp = parse_input(open(
        input_path("input0.inp")).read()
        .replace("TotalNumberOfSites=4", "TotalNumberOfSites=2")
        .replace("hubbardU 4\n0 0 0 0", "hubbardU 2 3 3")
        .replace("potentialV 8\n0 0 0 0\n0 0 0 0", "potentialV 4 0 0 0 0"))
    geom = Geometry(inp)
    model = build_model(inp, geom)
    path = str(tmp_path / "sectors.dat")
    nsec = sector_files.write_all_sectors(path, model, 2)
    sectors = sector_files.read_sectors(path)
    assert len(sectors) == nsec
    # grand-canonical Z from the file matches the in-process pipeline
    from lanczosplusplus_tpu.engine.thermal import GrandCanonical
    gc = GrandCanonical(model, nsite=2)
    beta, mu = 1.1, 0.3
    z_file = sum(np.exp(beta * (mu * sum(s["parts"]) - s["evals"])).sum()
                 for s in sectors)
    # file omits the vacuum sector? no: (0,0) included
    assert z_file == pytest.approx(gc.partition(beta, mu), rel=1e-9)
    # operator matrices consistent: <n_up(0)> via file data
    s11 = next(s for s in sectors if s["parts"] == (1, 1))
    dest, c0 = s11["operators"][("c", 0, 0)]
    assert dest == (0, 1)
    # sum over matrix elements squared = <sum over states n_0up> trace
    assert c0.shape[0] == 4
