"""The blocked float64 Cholesky factorisation (``ops.nonfactor.blocked_cholesky``)
and kernel G's wrapper (``ops.nonfactor.chol_block``) on the CPU.

The kernel runs on the card only (``chip_smoke.py`` phase 1d and the
``nonfactor`` section of ``tools/validate_kernels.py`` hold it to its plain
version there).  Here the blocked factor runs through the plain version
(``cholesky_ex`` and a triangular solve of each diagonal block): at orders
around the block width and with ragged last blocks it is
``torch.linalg.cholesky``'s within rounding, zero above its diagonal, and
fails on the draws ``cholesky_ex`` fails on, with the same ``info``; the
conditional densities through it hold to ``pyloo_tpu``'s with ``-inf``
rows where a draw failed; the route is a function of the device and the
order; the wrapper refuses what the kernel does not take and hands it the
strides it needs; the ``blocked_factor_draws`` counter and its benchmark
reader fit together.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from pyloo_tpu.ops import nonfactor as jnf
from pyloo_tpu_torch import _build, profiling, rcParams
from pyloo_tpu_torch.ops import nonfactor as tnf

from .torch_parity import F64

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "pyloo_tpu_torch" / "csrc" / "chol_block.cu"
NB = tnf._NB


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = rcParams["device.device"], rcParams["device.precision"]
    rcParams["device.device"] = "cpu"
    rcParams["device.precision"] = "float64"
    yield
    rcParams["device.device"], rcParams["device.precision"] = old


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _chunk(n, seed=0):
    """Three covariances of order ``n``: a sound one, one whose leading
    minor of order n // 2 + 1 is not positive definite, and one with a NaN
    below its diagonal (on it where n = 1); the upper triangles hold
    values the factor must not read."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, n, n))
    cov = a @ a.transpose(0, 2, 1) / n + np.eye(n)
    cov[1, n // 2, n // 2] = -5.0
    cov[2, n - 1, 0] = np.nan
    cov += np.triu(rng.normal(size=(3, n, n)), 1)
    return torch.from_numpy(cov)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("n", [1, NB - 1, NB, NB + 1, 300, 1100])
def test_the_blocked_factor_is_choleskys(n):
    cov = _chunk(n)
    got, info = tnf.blocked_cholesky(cov)
    want_l, want_info = torch.linalg.cholesky_ex(cov)
    assert info.dtype == torch.int32
    assert torch.equal(info, want_info)
    assert torch.equal(info != 0, torch.tensor([False, True, True]))
    want = torch.linalg.cholesky(cov[:1])
    assert _rel(got[:1], want) < 1e-13
    assert torch.equal(torch.tril(got[0]), got[0])
    assert torch.equal(got[0].triu(1), torch.zeros(n, n, dtype=torch.float64))


@pytest.mark.parametrize("n", [NB - 1, 300])
def test_a_column_major_chunk_reads_as_a_row_major_one(n):
    cov = _chunk(n)[:1]
    sym = torch.tril(cov) + torch.tril(cov, -1).mT
    got, info = tnf.blocked_cholesky(sym.mT)
    want, want_info = tnf.blocked_cholesky(sym.contiguous())
    assert torch.equal(got, want) and torch.equal(info, want_info)


@pytest.mark.parametrize("w", [1, 5, 64, 128])
def test_kernel_g_plain_block_factor_and_inverse(w):
    """The wrapper on a CPU tensor: ``L`` of the lower triangles, ``W`` the
    solve's ``L^{-1}``, both zero above their diagonals, and ``info`` set to
    ``k0`` + the failed column only where it was 0."""
    cov = _chunk(w, seed=w)
    l_out = torch.full_like(cov, 7.0)
    w_out = torch.full_like(cov, 7.0)
    info = torch.tensor([0, 0, 11], dtype=torch.int32)
    tnf.chol_block(cov, l_out, w_out, info, k0=256)
    want = torch.linalg.cholesky(cov[:1])
    eye = torch.eye(w, dtype=torch.float64)
    assert _rel(l_out[:1], want) < 1e-13
    assert _rel(w_out[:1], torch.linalg.solve_triangular(want, eye[None], upper=False)) < 1e-13
    assert _rel(l_out[0] @ w_out[0], eye) < 1e-13
    assert torch.equal(torch.tril(l_out[0]), l_out[0]) and torch.equal(torch.tril(w_out[0]),
                                                                       w_out[0])
    first = 1 if w == 1 else w // 2 + 1
    assert info.tolist() == [0, 256 + first, 11]


def test_kernel_g_plain_flags_a_pivot_that_is_not_finite():
    """A pivot that is +inf fails, as one <= 0 or NaN does: the first
    column whose pivot is not in (0, inf)."""
    cov = torch.eye(6, dtype=torch.float64).repeat(3, 1, 1)
    cov[0, 3, 3] = torch.inf
    cov[1, 2, 2] = 0.0
    cov[2, 4, 1] = torch.nan
    _, _, info = tnf.chol_block_plain(cov)
    assert info.tolist() == [4, 3, 5]


@pytest.mark.parametrize("n", [NB + 1, 300])
@pytest.mark.parametrize("kind", ["mvn", "mvt"])
def test_the_densities_through_the_blocked_factor(n, kind, monkeypatch):
    """The route taken on the CPU (as a card takes it): the conditional
    densities hold to ``pyloo_tpu``'s within 1e-12, a failed draw's row is
    ``-inf``, and the counter counts the chunk's draws under a profiler."""
    cov = _chunk(n, seed=3).numpy()
    cov = np.tril(cov) + np.tril(cov, -1).transpose(0, 2, 1)  # pyloo_tpu reads both halves
    rng = np.random.default_rng(n)
    y, mu = rng.normal(size=n), rng.normal(0, 0.1, size=(3, n))
    df = np.array([5.0, 7.0, 9.0])
    monkeypatch.setattr(tnf, "_blocked_route", lambda device_type, order: True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        if kind == "mvn":
            ll = tnf.mvn_conditional_loglik(y, mu, cov=cov).numpy()
        else:
            ll = tnf.mvt_conditional_loglik(y, mu, df, cov=cov).numpy()
    assert profiling.counters()["blocked_factor_draws"] == {"cov": 3}
    want = np.asarray(jnf.mvn_conditional_loglik(y, mu, cov=cov) if kind == "mvn"
                      else jnf.mvt_conditional_loglik(y, mu, df, cov=cov))
    assert np.isneginf(ll[1:]).all() and np.isfinite(ll[0]).all()
    assert_allclose(ll, want, **F64)


def test_the_cpu_takes_cholesky_ex_and_counts_nothing():
    cov = _chunk(NB + 1)[:1]
    cov = torch.tril(cov) + torch.tril(cov, -1).mT
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tnf.mvn_conditional_loglik(np.zeros(NB + 1), np.zeros((1, NB + 1)), cov=cov.numpy())
    assert "blocked_factor_draws" not in profiling.counters()
    assert profiling.counters()["factor_draws"] == {"cov": 1}


def test_the_route_is_the_device_and_the_order():
    """The card takes the blocked factor from the crossover measured on it
    (``_BLOCKED_FROM``: ``cholesky_ex`` on batches of small matrices was
    the faster at N = 128), the CPU never."""
    assert 128 < tnf._BLOCKED_FROM <= 300
    for n in (1, 128, tnf._BLOCKED_FROM - 1):
        assert not tnf._blocked_route("cuda", n)
    for n in (tnf._BLOCKED_FROM, 300, 512, 2048, 2100):
        assert tnf._blocked_route("cuda", n)
    for n in (1, 300, 2048, 1 << 20):
        assert not tnf._blocked_route("cpu", n)


def _block_args(b=3, w=5):
    c = torch.zeros(b, w, w, dtype=torch.float64)
    return c, torch.zeros_like(c), torch.zeros_like(c), torch.zeros(b, dtype=torch.int32)


@pytest.mark.parametrize("what", ["float32", "another shape", "strided columns", "int64 info",
                                  "info of another length", "w > 128"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(what):
    c, l_out, w_out, info = _block_args()
    if what == "float32":
        c = c.float()
    elif what == "another shape":
        l_out = torch.zeros(3, 4, 4, dtype=torch.float64)
    elif what == "strided columns":
        w_out = torch.zeros(3, 5, 10, dtype=torch.float64)[:, :, ::2]
    elif what == "int64 info":
        info = info.long()
    elif what == "info of another length":
        info = info[:2]
    else:
        c, l_out, w_out, info = _block_args(w=NB + 1)
    with pytest.raises(ValueError):
        tnf.chol_block(c, l_out, w_out, info, 0)


class _StandInLibrary:
    """The library's entry point for a launch that the CPU cannot make."""

    def __init__(self):
        self.launched = []
        self.blocked = []

    def pyloo_chol_block_f64(self, device, c, c_batch, c_ld, l, l_batch, l_ld, w, w_batch,
                             w_ld, info, b, width, k0, stream):
        self.launched.append((c_batch, c_ld, l_batch, l_ld, w_batch, w_ld, b, width, k0))
        return 0

    def pyloo_blocked_cholesky_f64(self, device, a, a_batch, a_ld, chol, col, w, info, b, n,
                                   stream):
        self.blocked.append((a, a_batch, a_ld, b, n))
        return 0


def test_a_launch_hands_the_kernel_its_strides(monkeypatch):
    """A launch (on a stand-in library: meta tensors take the kernel's
    branch, and nothing runs) passes each matrix's batch and row strides,
    the block's order and the offset of ``info``, and
    counts itself."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tnf, "_stream_of", lambda t: (0, 0))
    a = torch.empty(4, 300, 300, dtype=torch.float64, device="meta")
    buf = torch.empty(4, 300, 128, dtype=torch.float64, device="meta")
    w_jj = torch.empty(4, 128, 128, dtype=torch.float64, device="meta")
    info = torch.empty(4, dtype=torch.int32, device="meta")
    before = tnf.chol_block.launches
    tnf.chol_block(a[:, :128, :128], a[:, :128, :128], w_jj, info, 0)
    tnf.chol_block(buf[:, :44, :44], a[:, 256:, 256:], w_jj[:, :44, :44], info, 256)
    assert lib.launched == [(90_000, 300, 90_000, 300, 16_384, 128, 4, 128, 0),
                            (38_400, 128, 90_000, 300, 16_384, 128, 4, 44, 256)]
    assert tnf.chol_block.launches == before + 2


def test_the_cards_blocked_factor_is_one_library_call(monkeypatch):
    """The card's route (on a stand-in library and meta tensors, whose
    addresses are their byte offsets): one call hands the library the
    caller's matrices with their strides, the zeroed factor and the
    scratch, and counts a launch of kernel G a block column."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tnf, "_stream_of", lambda t: (0, 0))
    before = tnf.chol_block.launches
    whole = torch.empty(4, 310, 310, dtype=torch.float64, device="meta")
    got, info = tnf.blocked_cholesky(whole[:, 10:, 10:])
    assert got.shape == (4, 300, 300) and info.shape == (4,) and info.dtype == torch.int32
    got, info = tnf.blocked_cholesky(torch.empty(2, 100, 100, dtype=torch.float64, device="meta"))
    assert lib.blocked == [(8 * 3110, 96_100, 310, 4, 300), (0, 10_000, 100, 2, 100)]
    assert tnf.chol_block.launches == before + 3 + 1


def test_the_kernel_is_not_named_as_kernel_a():
    """``benchmark/measure.is_kernel_a`` finds kernel A's events by name:
    kernel G's and the column copy's must not match, or
    ``kernel_a_roofline`` would count them."""
    from benchmark import measure

    text = SOURCE.read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", text)
    assert names == ["chol_block_kernel", "copy_block_kernel"]
    assert not any(measure.is_kernel_a(name) for name in names)
    assert "chol_block.cu" in _build._SOURCES


def test_the_benchmark_reader_reads_the_counter_a_call(monkeypatch):
    from benchmark import core
    from benchmark.trace import Trace

    reader = core.load_module(ROOT / "benchmark" / "metrics" / "blocked_factor_draws_per_call.py",
                              "_tb_blocked_factor_draws_per_call")
    ctx = SimpleNamespace(trace=Trace(window=(0.0, 1.0), devices=[0], calls=2,
                                      ops=[("k", 0.0, 1.0, 0)], host=[]))
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"blocked_factor_draws": {"cov": 8_000}, "factor_draws": {"cov": 8_000}})
    assert reader.read(ctx) == 4_000.0
    # the route ran on no draw of the window (a CPU rehearsal): 0
    monkeypatch.setattr(profiling, "counters", lambda: {"factor_draws": {"cov": 8_000}})
    assert reader.read(ctx) == 0.0
    # no device operation traced: nothing
    assert reader.read(SimpleNamespace(trace=None)) is None
