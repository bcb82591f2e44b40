"""ctypes bindings for the native (C++) host-side KS integrator (a copy of
``pdecontrol_tpu/utils/native.py``: numpy and ctypes only).

``native/ks_solver.cc`` is built on first use (``g++ -O3 -shared -fPIC``)
into ``build/native/<hash>/libks_solver.so`` at the root of the checkout,
keyed by a hash of the source and the flags, so an edit rebuilds and an
unchanged tree reuses the library.  Unlike the JAX package's loader it never
writes ``native/``: the library tracked there stays as it is.  The solver
is float64 on one core: an independent golden oracle, and the single-core
host baseline beside the kernels (``chip_smoke.py`` phase 15).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "ks_solver.cc"
BUILD_ROOT = _ROOT / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / "libks_solver.so"


def build() -> Path:
    """Compile the solver unless the library for its hash exists; with
    ``-march=native`` where the compiler takes it."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename, so that a cut build, or one
    # of two processes building at once, never leaves a half library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    base = ["g++", *FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(base[:1] + ["-march=native"] + base[1:], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            proc = subprocess.run(base, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) for {SOURCE}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ks_control_period.argtypes = [
        dp, dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_int, ctypes.c_int,
    ]
    lib.ks_control_period.restype = None
    lib.ks_rhs.argtypes = [dp, dp, dp, ctypes.c_int, ctypes.c_double]
    lib.ks_rhs.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ks_control_period(
    u: np.ndarray, phi: np.ndarray, dx: float, dt: float, cfg_steps: int,
    objective: str = "l2control",
) -> Tuple[np.ndarray, np.ndarray]:
    """Advance [B, N] (or [N]) fields one control period; returns (u, reward)."""
    lib = load()
    squeeze = u.ndim == 1
    u = np.ascontiguousarray(np.atleast_2d(u), np.float64).copy()
    phi = np.ascontiguousarray(
        np.broadcast_to(np.atleast_2d(phi), u.shape), np.float64
    ).copy()
    b, n = u.shape
    rewards = np.zeros(b, np.float64)
    obj = 0 if objective == "l2control" else 1
    lib.ks_control_period(
        _ptr(u), _ptr(phi), _ptr(rewards), b, n, dx, dt, cfg_steps, obj
    )
    if squeeze:
        return u[0], rewards[0]
    return u, rewards


def ks_rhs(u: np.ndarray, phi: np.ndarray, dx: float) -> np.ndarray:
    lib = load()
    u = np.ascontiguousarray(u, np.float64)
    phi = np.ascontiguousarray(phi, np.float64)
    out = np.zeros_like(u)
    lib.ks_rhs(_ptr(u), _ptr(phi), _ptr(out), u.shape[-1], dx)
    return out
