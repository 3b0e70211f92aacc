"""pyloo_tpu_torch._build keeps the compiler's output beside the library.

There is no ``nvcc`` on a machine without the CUDA toolkit, so a stand-in
script takes its place: it prints what ``ptxas -v`` would and creates the
output file.  ``build_log`` must read the same whether this process compiled
the library or found it built.
"""

import stat
import sys

import pytest

from pyloo_tpu_torch import _build

_FAKE_NVCC = """#!{python}
import os
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    print("ptxas info    : Used 40 registers, 0 bytes spill stores, 0 bytes spill loads " + os.path.basename(out))
open(out, "w").write("built")
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_log", "")
    return tmp_path / "build"


def test_build_log_is_kept_beside_the_library(fake_toolchain):
    lib = _build.build()
    first = _build.build_log
    assert lib.read_text() == "built"
    assert first.count("0 bytes spill stores") == len(_build._SOURCES)
    assert lib.with_suffix(".log").read_text() == first
    # nothing of the build's working directory stays behind
    assert sorted(p.name for p in fake_toolchain.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])


def test_build_log_is_read_back_when_the_library_is_there(fake_toolchain, monkeypatch):
    lib = _build.build()
    first = _build.build_log
    monkeypatch.setattr(_build, "build_log", "")
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("compiled a second time"))
    assert _build.build() == lib
    assert _build.build_log == first != ""


def test_library_without_its_log_is_built_again(fake_toolchain, monkeypatch):
    lib = _build.build()
    first = _build.build_log
    lib.with_suffix(".log").unlink()
    monkeypatch.setattr(_build, "build_log", "")
    assert _build.build() == lib
    assert _build.build_log == first != ""
