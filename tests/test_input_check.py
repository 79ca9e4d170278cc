"""Input validation layer (reference: src/Engine/InputCheck.h:106-167
validates vector-label lengths and the SolverOptions vocabulary)."""

import pytest

from lanczosplusplus_tpu.io_.input_parser import parse_input
from lanczosplusplus_tpu.io_.input_check import (InputValidationError,
                                                 validate_input, usage)
from reference_inputs import input_path


GOOD = """
TotalNumberOfSites=4
NumberOfTerms=1
DegreesOfFreedom=1
GeometryKind=chain
GeometryOptions=ConstantValues
Connectors 1 -1.0
Model=HubbardOneBand
hubbardU 4
1 1 1 1
potentialV 8
0 0 0 0 0 0 0 0
SolverOptions=none
TargetElectronsUp=2
TargetElectronsDown=2
IsPeriodicX=1
"""


def test_good_input_validates():
    assert validate_input(parse_input(GOOD))


def test_wrong_length_hubbard_u_names_label():
    bad = GOOD.replace("hubbardU 4\n1 1 1 1", "hubbardU 3\n1 1 1")
    with pytest.raises(InputValidationError, match="hubbardU"):
        validate_input(parse_input(bad))


def test_wrong_length_potential_v_names_label():
    bad = GOOD.replace("potentialV 8\n0 0 0 0 0 0 0 0",
                       "potentialV 4\n0 0 0 0")
    with pytest.raises(InputValidationError, match="potentialV"):
        validate_input(parse_input(bad))


def test_missing_target_sector():
    bad = GOOD.replace("TargetElectronsUp=2\n", "")\
              .replace("TargetElectronsDown=2\n", "")
    with pytest.raises(InputValidationError, match="target"):
        validate_input(parse_input(bad))


def test_unknown_model():
    bad = GOOD.replace("Model=HubbardOneBand", "Model=Hubbbard")
    with pytest.raises(InputValidationError, match="Model"):
        validate_input(parse_input(bad))


def test_term_count_mismatch():
    bad = GOOD.replace("NumberOfTerms=1", "NumberOfTerms=2")
    with pytest.raises(InputValidationError, match="NumberOfTerms"):
        validate_input(parse_input(bad))


def test_missing_total_sites():
    bad = GOOD.replace("TotalNumberOfSites=4\n", "")
    with pytest.raises(InputValidationError,
                       match="TotalNumberOfSites"):
        validate_input(parse_input(bad))


def test_spin_orbit_shape():
    bad = GOOD + "\nSpinOrbit 2 2\n1 0 0 1\n"
    with pytest.raises(InputValidationError, match="SpinOrbit"):
        validate_input(parse_input(bad))


def test_heisenberg_field_length():
    text = """
TotalNumberOfSites=4
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
TargetSzPlusConst=2
SolverOptions=none
MagneticField 3
0.1 0.1 0.1
"""
    with pytest.raises(InputValidationError, match="MagneticField"):
        validate_input(parse_input(text))


def test_reference_inputs_validate():
    for name in ("input0.inp", "input10.inp", "input100.inp",
                 "input104.inp"):
        with open(input_path(name)) as f:
            assert validate_input(parse_input(f.read())), name


def test_usage_string():
    assert usage("lanczos").startswith("Usage: lanczos")
