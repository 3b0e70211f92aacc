"""Kernel F's wrapper (``ops.loo_kernels.psis_tail_fit``) on the CPU.

The kernel runs on the card only (``chip_smoke.py`` phase 1c and the
``fit`` section of ``tools/validate_kernels.py`` hold it to its plain
version there).  Here: a CPU tensor takes the plain version, which is the
float32 scorer's core (``_psis_tail_scores(..., exact=False)``) bit for bit;
the wrapper refuses what the kernel does not take; the plain route never
reaches it; its ``fit_kernel_rows`` counter moves only while a profiler
records; the source, the build and the benchmark's reader fit together.
Rows that make the fit degenerate without a stub (a tied tail of 100-120
draws) are degenerate in ``pyloo_tpu`` too.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pyloo_tpu.ops import loo_kernels as jk
from pyloo_tpu_torch import _build, profiling, rcParams
from pyloo_tpu_torch.ops import loo_kernels as tk
from pyloo_tpu_torch.ops import topk
from pyloo_tpu_torch.ops.psis import tail_length
from pyloo_tpu_torch.tools import validate_kernels as vk

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "pyloo_tpu_torch" / "csrc" / "psis_tail_fit.cu"


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = rcParams["device.device"]
    rcParams["device.device"] = "cpu"
    yield
    rcParams["device.device"] = old


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _tails(family, m, b=40, s=None, seed=0):
    """Kernel A's outputs (its plain version) on rows of ``family``."""
    s = s or max(400, 4 * (m + 1))
    x = vk.family_rows(family, b, s, m + 1, torch.Generator().manual_seed(seed), "cpu")
    vals, c, log_ntl, _ = topk.loo_prepass(x, m + 1)
    return vals, log_ntl, c, s


def _same(got, want):
    return all(torch.equal(torch.isnan(g), torch.isnan(w))
               and torch.equal(torch.where(torch.isnan(g), 0, g), torch.where(torch.isnan(w), 0, w))
               for g, w in zip(got, want))


@pytest.mark.parametrize("m", [1, 5, 33, 190])
@pytest.mark.parametrize("family", ["normal", "edge", "ties at k", "degenerate", "short tail"])
def test_cpu_tensor_is_the_scoring_core_bit_for_bit(family, m):
    vals, log_ntl, c, s = _tails(family, m)
    got = tk.psis_tail_fit(vals, log_ntl, c, s)
    xcutoff = torch.clamp_min(vals[:, m], topk._CUTOFF_FLOOR)
    ntl = torch.where(torch.isnan(xcutoff), -torch.inf, log_ntl)
    want = tk._psis_tail_scores(vals[:, :m], xcutoff, ntl, c, s, exact=False)
    assert _same(got, want)
    assert got[2].dtype == torch.bool


def test_a_strided_view_reads_as_the_contiguous_tails():
    vals, log_ntl, c, s = _tails("normal", 190, b=9)
    view = vk.as_view(vals, 3)
    assert view.stride(0) == 191 + vk.VIEW_PAD
    assert _same(tk.psis_tail_fit(view, log_ntl, c, s), tk.psis_tail_fit(vals, log_ntl, c, s))


@pytest.mark.parametrize("what", ["float64", "non-contiguous row", "M > 1023", "S < M + 1",
                                  "C of another length"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(what):
    vals, log_ntl, c, s = _tails("normal", 33, b=6)
    if what == "float64":
        args, error = (vals.double(), log_ntl.double(), c.double(), s), TypeError
    elif what == "non-contiguous row":
        wide = torch.zeros(6, 2 * 34)
        wide[:, ::2] = vals
        args, error = (wide[:, ::2], log_ntl, c, s), ValueError
    elif what == "M > 1023":
        args, error = (torch.zeros(2, 1025), torch.zeros(2), torch.zeros(2), 4000), ValueError
    elif what == "S < M + 1":
        args, error = (vals, log_ntl, c, 33), ValueError
    else:
        args, error = (vals, log_ntl, c[:5], s), ValueError
    with pytest.raises(error):
        tk.psis_tail_fit(*args)


def test_the_plain_route_never_calls_the_wrapper(monkeypatch):
    calls = []
    real = tk.psis_tail_fit

    def spy(*args, **kwargs):
        calls.append(args[-1] if len(args) > 4 else kwargs.get("route"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tk, "psis_tail_fit", spy)
    ll = -vk.family_rows("normal", 12, 400, 41, torch.Generator().manual_seed(1), "cpu")
    plain = tk.loo_scores_psis_fast(ll, 40, route="torch")
    assert calls == []
    fused = tk.loo_scores_psis_fast(ll, 40, route="cuda")
    assert calls == ["cuda"]
    for g, w in zip(fused[:2], plain[:2]):
        assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(fused[3], plain[3])


class _StandInLibrary:
    """The library's entry point for a launch that the CPU cannot make."""

    def __init__(self):
        self.launched = []

    def pyloo_psis_tail_fit_f32(self, device, vals, b, m, ld, *rest):
        self.launched.append((b, m, ld))
        return 0


def test_fit_kernel_rows_counts_only_while_a_profiler_records(monkeypatch):
    """A launch (on a stand-in library: a meta tensor takes the kernel's
    branch, and nothing runs) counts its rows under its route, and only
    while a profiler records; the launch count moves either way."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tk, "_launch_args", lambda x: (0, x.shape[1] + 5, 0))
    monkeypatch.setattr(tk, "_count_on", lambda by_device, device: None)
    vals = torch.empty(37, 191, device="meta")
    small = torch.empty(37, device="meta")
    before = tk.psis_tail_fit.launches
    tk.psis_tail_fit(vals, small, small, 4000)
    assert profiling.counters() == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tk.psis_tail_fit(vals, small, small, 4000, "cuda")
        tk.psis_tail_fit(vals[:5], small[:5], small[:5], 4000, "cuda-multipass")
    assert profiling.counters() == {"fit_kernel_rows": {"cuda": 37, "cuda-multipass": 5}}
    assert tk.psis_tail_fit.launches == before + 3
    assert lib.launched == [(37, 190, 196), (37, 190, 196), (5, 190, 196)]
    # a CPU tensor launches nothing and counts nothing, under a profiler too
    vals, log_ntl, c, s = _tails("normal", 33, b=6)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tk.psis_tail_fit(vals, log_ntl, c, s)
    assert profiling.counters() == {"fit_kernel_rows": {"cuda": 37, "cuda-multipass": 5}}
    assert len(lib.launched) == 3


def test_the_kernel_is_not_named_as_kernel_a():
    """``benchmark/measure.is_kernel_a`` finds kernel A's events by name:
    kernel F's must not match, or ``kernel_a_roofline`` would count it."""
    from benchmark import measure

    text = SOURCE.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text)
    assert names == ["psis_tail_fit_kernel"]
    assert not any(measure.is_kernel_a(name) for name in names)
    assert measure.KERNEL_A not in text


def test_the_build_lists_every_cuda_source():
    """The library is built from each source of ``_SOURCES``, kernel F's
    among them (so the spill count of ``test_torch_build`` is one line a
    source), and every CUDA source of ``csrc/`` is listed."""
    assert "psis_tail_fit.cu" in _build._SOURCES
    assert len(set(_build._SOURCES)) == len(_build._SOURCES)
    on_disk = {p.name for p in (ROOT / "pyloo_tpu_torch" / "csrc").glob("*.cu")}
    assert set(_build._SOURCES) == on_disk


def _metric(name):
    from benchmark import core

    return core.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"_tf_{name}")


def test_the_benchmark_reader_reads_the_counter_a_call(monkeypatch):
    from types import SimpleNamespace

    from benchmark.trace import Trace

    reader = _metric("fit_kernel_rows_per_call")
    ctx = SimpleNamespace(trace=Trace(window=(0.0, 1.0), devices=[0], calls=2,
                                      ops=[("k", 0.0, 1.0, 0)], host=[]))
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"fit_kernel_rows": {"cuda": 2_000_000}, "host_reads": {"a": 6}})
    assert reader.read(ctx) == 1_000_000.0
    # the kernel launched on no row of the window (a CPU rehearsal): 0
    monkeypatch.setattr(profiling, "counters", lambda: {"host_reads": {"a": 6}})
    assert reader.read(ctx) == 0.0
    # no traced window, or a program without the kernel or without counters
    # (the parent of this change): nothing to read
    assert reader.read(SimpleNamespace(trace=None)) is None
    monkeypatch.delattr(tk, "psis_tail_fit")
    assert reader.read(ctx) is None
    monkeypatch.undo()
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(ctx) is None


def test_tied_tails_degenerate_in_both_packages():
    """A top tie run of 100-120 draws over a tie at the cutoff: the tail's
    values are equal, the fit's 40 candidates include b = 0 exactly, and
    both packages flag the row degenerate and keep its unsmoothed tail."""
    s = 2000
    m = tail_length(s)
    x = vk.family_rows("degenerate", 21, s, m + 1, torch.Generator().manual_seed(2), "cpu")
    ll = (-x).numpy()
    got = tk.loo_scores_psis_fast(torch.from_numpy(ll), m)
    want = [np.asarray(w) for w in jk.loo_scores_psis_fast(jnp.asarray(ll), m)]
    assert got[3].all() and want[3].all()
    assert_allclose(got[0].numpy(), want[0], rtol=1e-5, atol=1e-5)
    assert_allclose(got[1].numpy(), want[1], rtol=0, atol=1e-5)
