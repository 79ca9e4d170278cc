"""Global numeric configuration.

The reference is double precision throughout (reference:
src/Engine/LanczosDriver.h:29-33, RealType = double unless USE_FLOAT).
On an accelerator we default to float32 plus refinement and make the
dtype an explicit knob; CPU tests run float64 for reference-tolerance
checks.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp


def default_real_dtype():
    """float64 when x64 is enabled (CPU tests), else float32."""
    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def complex_dtype_for(real_dtype) -> jnp.dtype:
    return jnp.dtype(jnp.complex128 if jnp.dtype(real_dtype) == jnp.float64
                     else jnp.complex64)


def matmul_precision():
    """Precision of every GEMM on the solver and observable paths.

    True float32 ("highest") unless the caller opts into another mode
    for a region with `jax.default_matmul_precision(...)`.  On a GPU a
    float32 product at default precision may run in TF32, which keeps
    about three decimal digits and breaks the f32-plus-refinement
    accuracy bars.  The setting is part of jit's cache key, so compiled
    functions retrace when a caller changes it."""
    return jax.config.jax_default_matmul_precision or "highest"


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry point.

    When JAX_COMPILATION_CACHE_DIR is set, JAX already uses it and
    nothing is set here.  Otherwise the cache lives at one fixed path
    inside the checkout (the path is part of the cache key, so it must
    not move between runs).  Called by the command-line entry points,
    never at import, so library users and tests keep their own setting.
    Returns the cache directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(repo_root(), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass
class Config:
    """Solver configuration (reference: PsimagLite ParametersForSolver read
    from the input file, used at src/Engine/Engine.h:60-65)."""

    lanczos_steps: int = 200
    lanczos_eps: float = 1e-12
    seed: int = 7239443
    use_complex: bool = False
    real_dtype: object = None

    def __post_init__(self):
        if self.real_dtype is None:
            self.real_dtype = default_real_dtype()

    @property
    def scalar_dtype(self):
        if self.use_complex:
            return complex_dtype_for(self.real_dtype)
        return jnp.dtype(self.real_dtype)
