"""The staged host-to-device copy (``pyloo_tpu_torch._staging``) on the CPU.

On a card, a host array of two slabs or more goes to the device through a
ring of pinned buffers that several host threads fill; here the same slab
walk runs into a CPU destination through an unpinned ring of small slabs,
and is held bit for bit to ``torch.from_numpy(a)`` (and its cast): whole
slabs, a ragged last slab, less than a slab, nothing.  With the route
forced on for the CPU, ``as_sample_matrix`` gives the matrix of
``Tensor.to`` bit for bit in each input form, and counts
``h2d_staged_bytes`` equal to ``h2d_bytes``; with the route off it counts
no staged byte.  Calls from many threads through one ring each get their
own bytes.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from pyloo_tpu_torch import _staging, containers, profiling, rcParams
from pyloo_tpu_torch.base import as_sample_matrix
from pyloo_tpu_torch.containers import DataArray

torch.set_num_threads(1)
CPU = torch.device("cpu")
SLAB = 4096  # bytes: 512 float64 or 1,024 float32 values a slab


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = rcParams["device.device"]
    rcParams["device.device"] = "cpu"
    yield
    rcParams["device.device"] = old


@pytest.fixture(autouse=True)
def _small_lazy_stacks(monkeypatch):
    """``stack`` defers the transpose of these small arrays too."""
    monkeypatch.setattr(containers, "_LAZY_STACK_MIN_ELEMS", 1)


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture
def ring():
    ring = _staging.Ring(CPU, slab_bytes=SLAB)
    yield ring
    ring.close()


@pytest.fixture
def staged_on_cpu(monkeypatch, ring):
    """The route forced on for the CPU, at :data:`SLAB`-byte slabs."""
    monkeypatch.setattr(_staging, "SLAB_BYTES", SLAB)
    monkeypatch.setattr(_staging, "_pays", lambda device, nbytes: nbytes >= 2 * SLAB)
    monkeypatch.setattr(_staging, "ring_for", lambda device: ring)
    return ring


# in slabs: whole slabs, a ragged last one, less than one, none; the first
# two go round the ring's buffers more than twice
SIZES = {"whole_slabs": 40.0, "ragged": 37.37, "under_a_slab": 0.41, "empty": 0.0}


def _host(dtype, slabs, seed=0):
    n = int(slabs * SLAB // np.dtype(dtype).itemsize)
    a = np.random.default_rng(seed).normal(size=n).astype(dtype)
    a[::97] = np.inf  # values a cast must carry as they are
    return a


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_the_slab_walk_copies_every_byte(ring, dtype, size):
    a = _host(dtype, SIZES[size])
    want = torch.from_numpy(a)
    dst = torch.full_like(want, np.nan)
    _staging.copy_into(dst, a, ring)
    assert torch.equal(dst, want)


@pytest.mark.parametrize("size", ["whole_slabs", "ragged"])
def test_the_fill_casts_as_tensor_to_does(ring, size):
    a = _host(np.float64, SIZES[size]) * 1e-39  # float32 subnormals among them
    dst = torch.empty(a.shape, dtype=torch.float32)
    _staging.copy_into(dst, a, ring)
    assert torch.equal(dst, torch.from_numpy(a).to(torch.float32))


def test_the_walk_refuses_a_destination_of_another_size(ring):
    with pytest.raises(ValueError, match="host elements"):
        _staging.copy_into(torch.empty(10), np.zeros(11, np.float32), ring)


def test_the_route_pays_only_for_two_slabs_to_a_card():
    slab = _staging.SLAB_BYTES
    assert not _staging._pays(CPU, 100 * slab)
    assert not _staging._pays(torch.device("cuda"), 2 * slab - 1)
    assert _staging._pays(torch.device("cuda"), 2 * slab)
    assert _staging.RING_BUFFERS * slab <= 256 << 20
    assert 1 <= _staging.FILL_THREADS <= 8


def test_to_device_through_the_ring_is_tensor_to(staged_on_cpu):
    a = _host(np.float64, 20.5).reshape(-1, 8)
    src = torch.from_numpy(a)
    for dtype in (None, torch.float32):
        got = _staging.to_device(src, CPU, dtype)
        assert got.data_ptr() != src.data_ptr()  # a copy through the ring
        assert torch.equal(got, src.to(CPU, dtype or src.dtype))


def _draws():
    """A ``(chain, draw, obs)`` float64 array of 20.6 slabs (10.3 in float32)."""
    return _host(np.float64, 2 * 11 * 479 * 8 / SLAB).reshape(2, 11, 479)


def _forms(a):
    """``as_sample_matrix``'s four input forms of a ``(chain, draw, obs)`` array."""
    chain, draw, obs = a.shape
    da = DataArray(a, ("chain", "draw", "obs"), {}, "y")
    rows = np.ascontiguousarray(np.moveaxis(a, 2, 0).reshape(obs, chain * draw))
    return {
        "lazy": lambda: da.stack(__sample__=("chain", "draw")),
        "stacked": lambda: DataArray(rows, ("obs", "__sample__"), {}, "y"),
        "ndarray": lambda: rows,
        "tensor": lambda: torch.from_numpy(rows),
    }


@pytest.mark.parametrize("form", ["lazy", "stacked", "ndarray", "tensor"])
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_as_sample_matrix_is_the_same_bit_for_bit(monkeypatch, ring, form, precision):
    a = _draws()
    make = _forms(a)[form]
    monkeypatch.setitem(rcParams, "device.precision", precision)
    assert form != "lazy" or make()._lazy is not None
    want, s_want, _ = as_sample_matrix(make())
    monkeypatch.setattr(_staging, "SLAB_BYTES", SLAB)
    monkeypatch.setattr(_staging, "_pays", lambda device, nbytes: nbytes >= 2 * SLAB)
    monkeypatch.setattr(_staging, "ring_for", lambda device: ring)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got, s_got, _ = as_sample_matrix(make())
    assert s_got == s_want and got.dtype == want.dtype
    assert torch.equal(got, want)
    counted = profiling.counters()
    assert counted["h2d_staged_bytes"] == counted["h2d_bytes"] == {"ingest": a.nbytes}


def test_no_staged_byte_is_counted_off_the_route():
    a = _draws()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for make in _forms(a).values():
            as_sample_matrix(make())
    assert profiling.counters() == {"h2d_bytes": {"ingest": 4 * a.nbytes}}


def test_threads_sharing_one_ring_each_get_their_own_bytes(ring):
    arrays = [_host(np.float32, 20.3, seed=i) for i in range(12)]  # more callers than cores
    got = [torch.empty(a.shape, dtype=torch.float32) for a in arrays]
    errors = []

    def copy(i):
        try:
            for _ in range(3):
                _staging.copy_into(got[i], arrays[i], ring)
        except Exception as err:  # noqa: BLE001  (reported by the assertion below)
            errors.append(err)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=copy, args=(i,)) for i in range(len(arrays))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert all(torch.equal(g, torch.from_numpy(a)) for g, a in zip(got, arrays))
