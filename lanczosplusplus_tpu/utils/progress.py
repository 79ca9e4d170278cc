"""Wall-clock-stamped progress logging.

Replaces PsimagLite::ProgressIndicator ("Class [T]: message" lines,
reference: src/Engine/Engine.h:86, 677).  Optionally wraps phases in a
jax.profiler trace when LPP_PROFILE_DIR is set.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_T0 = time.time()


class ProgressIndicator:
    def __init__(self, name: str, stream=None):
        self.name = name
        self.stream = stream or sys.stderr
        self.seconds = {}       # label -> wall seconds of its last phase

    def __call__(self, msg: str):
        t = time.time() - _T0
        self.stream.write(f"{self.name} [{t:.2f}]: {msg}\n")

    @contextlib.contextmanager
    def phase(self, label: str, detail: str = ""):
        self(f"{label} {detail} starting" if detail else
             f"{label} starting")
        t0 = time.perf_counter()
        profile_dir = os.environ.get("LPP_PROFILE_DIR")
        ctx = contextlib.nullcontext()
        if profile_dir:
            import jax
            ctx = jax.profiler.trace(profile_dir)
        with ctx:
            yield
        self.seconds[label] = time.perf_counter() - t0
        self(f"{label} done in {self.seconds[label]:.3f}s")
