"""ctypes binding of the host chunk prefetcher (``csrc/chunk_reader.cpp``).

Counterpart of ``pyloo_tpu/_native/__init__.py``.  The shared object is
compiled at first use with the host C++ compiler (``$CXX``, else ``g++`` or
``c++``) into ``build/pyloo_tpu_torch/`` beside the package, named by a hash
of the source, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built at import.

When no compiler is found, or the build or the load fails,
:func:`load_library` returns ``None`` and :class:`pyloo_tpu_torch.io.NpyLogLik`
reads through ``np.memmap`` instead: both readers put the same bytes in the
same host buffer, so this is a choice of host reader, not of device.  Set
``PYLOO_TPU_NO_NATIVE=1`` to take the memmap reader without trying a build.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ._build import BUILD_DIR

__all__ = ["load_library"]

_log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "csrc" / "chunk_reader.cpp"
_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: "ctypes.CDLL | None | bool" = False  # False: not tried yet


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_CXX_FLAGS).encode())
    return BUILD_DIR / f"libchunk_reader_{digest.hexdigest()[:16]}.so"


def _build(so_path: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        _log.info("no C++ compiler found; NpyLogLik reads through np.memmap")
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary name and rename: concurrent processes race benignly
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *_CXX_FLAGS, str(_SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            _log.warning(
                "chunk reader build failed (%s); NpyLogLik reads through np.memmap:\n%s",
                cxx, proc.stderr.strip()[:2000],
            )
            return False
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.TimeoutExpired) as exc:
        _log.warning("chunk reader build failed: %s", exc)
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> "ctypes.CDLL | None":
    """The compiled chunk-reader library, or ``None`` if it is unavailable.

    Thread-safe and memoized, a negative result included, so a missing
    compiler is probed once per process.
    """
    global _lib
    with _lock:
        if _lib is not False:
            return _lib
        if os.environ.get("PYLOO_TPU_NO_NATIVE"):
            _lib = None
            return None
        so_path = _library_path()
        if not so_path.exists() and not _build(so_path):
            _lib = None
            return None
        try:
            lib = ctypes.CDLL(str(so_path))
        except OSError as exc:
            _log.warning("failed to load %s: %s", so_path, exc)
            _lib = None
            return None
        lib.cr_open.restype = ctypes.c_void_p
        lib.cr_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.cr_read.restype = ctypes.c_int64
        lib.cr_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.cr_close.restype = None
        lib.cr_close.argtypes = [ctypes.c_void_p]
        lib.cr_reads_issued.restype = ctypes.c_int64
        lib.cr_reads_issued.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib
