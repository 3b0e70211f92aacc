"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
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
_SOURCES = ("topk_prepass.cu", "topk_bitonic.cu")
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [work / f"{src.stem}.o" for src in sources]
        compiles = [
            [_nvcc(), *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources, objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        outs = [proc.communicate()[0] for proc in procs]
        build_log = "".join(outs)
        for cmd, proc, out in zip(compiles, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n{out}")
        tmp = work / lib_path.name
        link = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{' '.join(link)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
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
        for name in ("pyloo_topk_reshape_f32", "pyloo_topk_natural_f32"):
            fn = getattr(lib, name)
            fn.argtypes = [_INT, _VOID_P, _INT, _INT, _INT, _INT, _VOID_P, _VOID_P]
            fn.restype = _INT
        lib.pyloo_error_string.argtypes = [_INT]
        lib.pyloo_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
