"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build happens at the first kernel launch (never at import), from the
package's own sources, into ``build/pyloo_tpu_torch/`` beside the package.
The library name carries a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "build", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "pyloo_tpu_torch"
_SOURCES = ("topk_prepass.cu",)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOID_P = ctypes.c_void_p
_INT = ctypes.c_int
_lib: ctypes.CDLL | None = None
build_log: str = ""  # nvcc's output of the last build (ptxas register/smem use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (looked in PATH and $CUDA_HOME/bin): the CUDA kernels"
        " of pyloo_tpu_torch are built from source at first use"
    )


def build() -> Path:
    """Compile the kernels (once per source hash) and return the library path."""
    global build_log
    sources = [_CSRC / name for name in _SOURCES]
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libpyloo_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.pyloo_loo_prepass_f32.argtypes = [
            _INT, _VOID_P, _INT, _INT, _INT, _INT,
            _VOID_P, _VOID_P, _VOID_P, _VOID_P, _VOID_P,
        ]
        lib.pyloo_loo_prepass_f32.restype = _INT
        lib.pyloo_topk_desc_f32.argtypes = [
            _INT, _VOID_P, _INT, _INT, _INT, _INT, _VOID_P, _VOID_P,
        ]
        lib.pyloo_topk_desc_f32.restype = _INT
        lib.pyloo_error_string.argtypes = [_INT]
        lib.pyloo_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
