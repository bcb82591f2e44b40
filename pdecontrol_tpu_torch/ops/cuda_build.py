"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel in ``pdecontrol_tpu_torch/csrc/`` has a plain C interface.  It
is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/<hash>/`` at the root of the checkout, keyed by a hash of
the source and the flags, so an edit rebuilds and an unchanged tree reuses
the library.  What nvcc prints (with ``-Xptxas -v``, each kernel's
registers, shared memory and spills) is kept beside the library.  Nothing
here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``; a CUDA
    host without it cannot build the kernels, which is an error."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / (Path(source).stem + ".so")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless the library for its hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename, so that a cut build never
    # leaves a library that looks finished.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {source}:\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(source: str) -> str:
    """What nvcc printed when it built ``csrc/<source>``."""
    return build(source).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    return ctypes.CDLL(str(build(source)))
