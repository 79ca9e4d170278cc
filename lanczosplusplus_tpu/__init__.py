"""lanczosplusplus_tpu: an exact-diagonalization framework for accelerators.

A from-scratch JAX/XLA re-design with the capabilities of
g1257/LanczosPlusPlus (C++ Lanczos exact diagonalization for models of
strongly correlated electrons): symmetry-sector bases, sparse Hamiltonian
assembly, Lanczos ground states, spectral functions via continued
fractions, static correlators, reduced density matrices and
finite-temperature averages — built for an accelerator:

- bit-string bases are device arrays of uint64 words with vectorized
  combinadic ranking (reference: src/Models/HubbardOneOrbital/BasisOneSpin.h:52-81)
- Hamiltonians are bounded-row sparse (ELL) index maps built from model
  term lists, applied as gather/segment kernels
  (reference: src/Models/HubbardOneOrbital/HubbardHelper.h:75-134)
- the Lanczos loop is a `lax`-compiled scan of SpMV + full
  reorthogonalization GEMMs (reference: PsimagLite LanczosSolver used at
  src/Engine/Engine.h:601-657)
- distribution is row-sharding of each sector over a `jax.sharding.Mesh`
  (replaces the reference's pthreads `Parallelizer2` row loop).
"""

__version__ = "0.1.0"

from lanczosplusplus_tpu.config import Config  # noqa: F401


def load(path_or_text: str):
    """Convenience one-liner: input file/text -> diagonalized Engine."""
    import os

    from lanczosplusplus_tpu.io_.input_parser import (parse_input,
                                                      read_input)
    from lanczosplusplus_tpu.geometry import Geometry
    from lanczosplusplus_tpu.models import build_model
    from lanczosplusplus_tpu.engine import Engine

    inp = read_input(path_or_text) if os.path.exists(path_or_text) \
        else parse_input(path_or_text)
    geometry = Geometry(inp)
    model = build_model(inp, geometry)
    return Engine(model, inp)
