"""The reference TestSuite inputs the tests drive, kept in tests/data.

input0 (4-site Hubbard chain, U=0), input10 (4-site Rashba chain, one
electron), input100 (6-site two-orbital FeAs, INT_PAPER33) and input104
(input100 plus AnisotropyD=7) are transcriptions carrying the labels
this engine reads; labels the engine never reads may be missing.
input10 also sets `dumpmatrix` in SolverOptions, so the CLI prints the
full spectrum that tests/test_cli.py checks against the Rashba
dispersion.
"""

import os

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def input_path(name: str) -> str:
    """Absolute path of tests/data/<name>."""
    return os.path.join(DATA_DIR, name)
