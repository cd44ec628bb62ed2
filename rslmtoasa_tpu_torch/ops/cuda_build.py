"""Build one CUDA source of the port into a shared library with nvcc.

Each kernel module keeps its source in ``csrc/`` and its library in
``_build/`` (gitignored) and builds it at first use, and again whenever the
source is newer than the library.  The sources have a plain C interface and
are loaded with ctypes, so nvcc takes seconds, not the minutes of a build
that includes PyTorch's headers.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def build(source: str, library: str) -> str:
    """Compile ``source`` into ``library``.

    Returns nvcc's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel).  The library is written under a temporary name and
    renamed, so a reader never sees a half-written file."""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(library))
    os.close(fd)
    try:
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, library)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return res.stdout + res.stderr


def is_current(source: str, library: str) -> bool:
    return (os.path.exists(library)
            and os.path.getmtime(library) >= os.path.getmtime(source))
