"""``pyloo_tpu_torch.io`` (disk chunk sources) against ``pyloo_tpu.io`` on the CPU.

One seeded ``(123, 61)`` float64 matrix saved as ``.npy`` goes through
``loo_from_file`` / ``waic_from_file`` of both packages, with the native
prefetcher (``csrc/chunk_reader.cpp``, built here with ``g++`` into
``build/pyloo_tpu_torch/``) and with the ``np.memmap`` reader.  Float64
results agree with ``pyloo_tpu`` within rtol and atol 1e-12, and equal the
port's own ``loo_streaming`` over a generator of the same rows bit for bit;
float32 within rtol and atol 1e-5.  The reader cases of ``tests/test_io.py``
(tail padding, out-of-order reads, forward skips at every ring depth, the
3-D layout, metadata checks, checkpoint resume) run on the port's copy of
the reader; the sharded case has no counterpart (one device).
"""

import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu_torch import _native
from pyloo_tpu_torch.io import NpyLogLik
from pyloo_tpu_torch.streaming import _chunks

N_OBS, N_DRAWS = 123, 61  # deliberately not multiples of any chunk size
F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-5)
READERS = [False, True]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old, threads = tpl.rcParams["device.device"], torch.get_num_threads()
    tpl.rcParams["device.device"] = "cpu"
    torch.set_num_threads(1)  # the test workers share the host's cores
    yield
    tpl.rcParams["device.device"] = old
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ll_matrix():
    return np.random.default_rng(7).normal(-1.0, 0.8, size=(N_OBS, N_DRAWS))


@pytest.fixture(scope="module")
def ll_file(ll_matrix, tmp_path_factory):
    path = tmp_path_factory.mktemp("io") / "ll.npy"
    np.save(path, ll_matrix)
    return str(path)


@pytest.fixture(scope="module")
def jax_refs(ll_file):
    """pyloo_tpu's loo_from_file by chunk size (the reader does not change it)."""
    cache = {}

    def get(chunk):
        if chunk not in cache:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                cache[chunk] = jpl.loo_from_file(ll_file, chunk_size=chunk, dtype=jnp.float64,
                                                 pointwise=True)
        return cache[chunk]

    return get


def _gen(matrix):
    t = torch.from_numpy(np.ascontiguousarray(matrix))
    return lambda idx: t[idx]


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def test_native_library_builds():
    # g++ is here: the native reader is the default (the memmap reader is for
    # hosts without a compiler), built beside the CUDA library, not in csrc/
    assert _native.load_library() is not None
    assert _native._library_path().parent.parts[-2:] == ("build", "pyloo_tpu_torch")
    assert _native._library_path().exists()


@pytest.mark.parametrize("native", READERS)
@pytest.mark.parametrize("chunk", [16, 40, 123, 200])
def test_loo_from_file_matches_streaming(ll_matrix, ll_file, jax_refs, native, chunk):
    res = _quiet(tpl.loo_from_file, ll_file, native=native, chunk_size=chunk,
                 dtype="float64", pointwise=True)
    ref = _quiet(tpl.loo_streaming, _gen(ll_matrix), N_OBS, N_DRAWS, chunk_size=chunk,
                 dtype="float64", pointwise=True)
    assert res["elpd_loo"] == ref["elpd_loo"]
    assert res["p_loo"] == ref["p_loo"]
    assert_array_equal(res.loo_i.values, ref.loo_i.values)
    assert_array_equal(res.pareto_k.values, ref.pareto_k.values)
    jres = jax_refs(chunk)
    for key in ("elpd_loo", "se", "p_loo", "p_loo_se", "looic"):
        assert_allclose(res[key], jres[key], err_msg=key, **F64)
    assert_allclose(res.loo_i.values, np.asarray(jres.loo_i.values), **F64)
    assert_allclose(res.pareto_k.values, np.asarray(jres.pareto_k.values), **F64)
    assert str(res) == str(jres)


@pytest.mark.parametrize("native", READERS)
def test_waic_from_file(ll_file, native):
    res = _quiet(tpl.waic_from_file, ll_file, native=native, chunk_size=40, dtype="float64")
    ref = _quiet(jpl.waic_from_file, ll_file, native=native, chunk_size=40, dtype=jnp.float64)
    for key in ("elpd_waic", "se", "p_waic"):
        assert_allclose(res[key], ref[key], err_msg=key, **F64)
    assert res["warning"] == ref["warning"]


@pytest.mark.parametrize("native", READERS)
def test_source_reads_match_file(ll_matrix, ll_file, native):
    src = NpyLogLik(ll_file, native=native)
    assert (src.n_obs, src.n_draws) == (N_OBS, N_DRAWS)
    assert src.is_native is native
    with src:
        assert_array_equal(src.read_rows(0, 40), ll_matrix[:40])
        assert_array_equal(src.read_rows(40, 40), ll_matrix[40:80])
        # tail chunk: rows past EOF repeat the last file row
        tail = src.read_rows(120, 40)
        assert_array_equal(tail[:3], ll_matrix[120:])
        assert_array_equal(tail[3:], np.broadcast_to(ll_matrix[-1], (37, N_DRAWS)))


@pytest.mark.parametrize("native", READERS)
def test_read_into_a_caller_tensor(ll_matrix, ll_file, native):
    # the streaming loop's path: the reader writes into the staging tensor's
    # own memory, tail rows padded as read_rows pads them
    out = torch.full((40, N_DRAWS), np.nan, dtype=torch.float64)
    ptr = out.data_ptr()
    with NpyLogLik(ll_file, native=native) as src:
        src._read_into(120, out)
        assert out.data_ptr() == ptr
        assert_array_equal(out.numpy(), src.read_rows(120, 40))
        assert_array_equal(out.numpy()[:3], ll_matrix[120:])
        for bad in (torch.empty(40, N_DRAWS, dtype=torch.float32),
                    torch.empty(40, N_DRAWS + 1, dtype=torch.float64),
                    torch.empty(N_DRAWS, 40, dtype=torch.float64).T):
            with pytest.raises(ValueError, match="contiguous"):
                src._read_into(0, bad)


@pytest.mark.parametrize("native", READERS)
def test_out_of_order_reads(ll_file, ll_matrix, native):
    # a checkpoint resume starts mid-file; backward seeks work too
    with NpyLogLik(ll_file, native=native) as src:
        c2 = src.read_rows(64, 32)
        c0 = src.read_rows(0, 32)
        c1 = src.read_rows(32, 32)
    assert_array_equal(c0, ll_matrix[:32])
    assert_array_equal(c1, ll_matrix[32:64])
    assert_array_equal(c2, ll_matrix[64:96])


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_forward_skip_never_deadlocks(ll_file, ll_matrix, depth):
    # skips forward inside the prefetch window, and skips that land on the
    # ring slot of the chunk being read, at every ring depth, under a watchdog
    chunk_rows = 8  # 16 chunks of the 123-row file
    n_chunks = -(-N_OBS // chunk_rows)
    patterns = [
        [0, 2, 4],
        [0, 1, 2, 3, 6, 10],
        [0, 3, 1, 7, 2, 9, 15],
        [2, 5, 8, 11, 14],
        list(range(0, n_chunks, 2)),
        [0, 1 + depth, 2 + depth],
    ]
    failures: list[str] = []

    def run():
        for pat in patterns:
            for _ in range(4):  # repeat: the slot alias needs a read in flight
                with NpyLogLik(ll_file, depth=depth, native=True) as src:
                    for c in pat:
                        got = src.read_rows(c * chunk_rows, chunk_rows)
                        lo, hi = c * chunk_rows, min((c + 1) * chunk_rows, N_OBS)
                        if not np.array_equal(got[: hi - lo], ll_matrix[lo:hi]):
                            failures.append(f"pattern {pat}: wrong data at {c}")
                            return

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120.0)
    assert not t.is_alive(), f"native reader deadlocked on a forward skip at depth={depth}"
    assert not failures, failures


def test_skip_while_in_flight_depth1(tmp_path):
    # one ring slot: consume chunk 0, let the producer claim chunk 1, then ask
    # for chunk 2 while 1 is being read (4 MB chunks widen that window)
    row_elems, chunk_rows, n_rows = 8192, 64, 64 * 12
    path = tmp_path / "big.npy"
    np.save(path, np.arange(n_rows * row_elems, dtype=np.float64).reshape(n_rows, row_elems))
    failures: list[str] = []

    def run():
        for _ in range(10):
            with NpyLogLik(str(path), depth=1, native=True) as src:
                for c in [0, 2, 4, 6, 8]:
                    got = src.read_rows(c * chunk_rows, chunk_rows)
                    if got[0, 0] != c * chunk_rows * row_elems:
                        failures.append(f"wrong data at chunk {c}")
                        return
                    time.sleep(2e-4)  # let the producer claim the next chunk

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60.0)
    assert not t.is_alive(), "native reader deadlocked: depth=1 skip while in flight"
    assert not failures, failures


@pytest.mark.parametrize("native", READERS)
def test_three_dim_layout(tmp_path, native):
    # (n_obs, n_chains, n_draws) flattens chains into draws, as __sample__ stacks them
    ll3 = np.random.default_rng(3).normal(size=(50, 4, 25))
    path = tmp_path / "ll3.npy"
    np.save(path, ll3)
    res = _quiet(tpl.loo_from_file, str(path), native=native, chunk_size=16, dtype="float64")
    ref = _quiet(jpl.loo_from_file, str(path), chunk_size=16, dtype=jnp.float64)
    assert res["n_samples"] == ref["n_samples"] == 100
    assert_allclose(res["elpd_loo"], ref["elpd_loo"], **F64)
    own = _quiet(tpl.loo_streaming, _gen(ll3.reshape(50, 100)), 50, 100, chunk_size=16,
                 dtype="float64")
    assert res["elpd_loo"] == own["elpd_loo"]


@pytest.mark.parametrize("native", READERS)
def test_float32_file_float64_compute(tmp_path, ll_matrix, native):
    # the file's float32 rows are staged as float32 and cast on the device
    path = tmp_path / "ll32.npy"
    ll32 = ll_matrix.astype(np.float32)
    np.save(path, ll32)
    res = _quiet(tpl.loo_from_file, str(path), native=native, chunk_size=40, dtype="float64",
                 pointwise=True)
    ref = _quiet(jpl.loo_from_file, str(path), chunk_size=40, dtype=jnp.float64, pointwise=True)
    assert_allclose(res["elpd_loo"], ref["elpd_loo"], **F64)
    assert_allclose(res.loo_i.values, np.asarray(ref.loo_i.values), **F64)
    own = _quiet(tpl.loo_streaming, _gen(ll32.astype(np.float64)), N_OBS, N_DRAWS,
                 chunk_size=40, dtype="float64")
    assert res["elpd_loo"] == own["elpd_loo"]


@pytest.mark.parametrize("native", READERS)
def test_float32_compute(ll_file, native):
    res = _quiet(tpl.loo_from_file, ll_file, native=native, chunk_size=40, dtype="float32",
                 pointwise=True)
    ref = _quiet(jpl.loo_from_file, ll_file, chunk_size=40, dtype=jnp.float32, pointwise=True)
    for key in ("elpd_loo", "se", "p_loo"):
        assert_allclose(res[key], ref[key], err_msg=key, **F32)
    assert_allclose(res.loo_i.values, np.asarray(ref.loo_i.values), **F32)


def test_metadata_validation(tmp_path):
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((4, 5), dtype=np.int32))
    with pytest.raises(ValueError, match="float32/float64"):
        NpyLogLik(str(bad))
    np.save(bad, np.zeros(7))
    with pytest.raises(ValueError, match="n_obs, n_draws"):
        NpyLogLik(str(bad))
    np.save(bad, np.asfortranarray(np.zeros((4, 5))))
    with pytest.raises(ValueError, match="C-order"):
        NpyLogLik(str(bad))
    np.save(bad, np.zeros((4, 5)))
    with pytest.raises(ValueError, match="depth"):
        NpyLogLik(str(bad), depth=0)


@pytest.mark.parametrize("native", READERS)
def test_n_obs_or_draws_not_in_the_file_rejected(ll_file, native):
    with NpyLogLik(ll_file, native=native) as src:
        with pytest.raises(ValueError, match="exceeds"):
            tpl.loo_streaming(src, N_OBS + 1, N_DRAWS, chunk_size=40)
        with pytest.raises(ValueError, match="61 draws per row, but n_draws is 60"):
            tpl.waic_streaming(src, N_OBS, N_DRAWS - 1, chunk_size=40)


def test_misaligned_read_rejected(ll_file):
    with NpyLogLik(ll_file) as src:
        with pytest.raises(ValueError, match="multiple"):
            src.read_rows(7, 40)
        with pytest.raises(ValueError, match="past the end"):
            src.read_rows(160, 40)


@pytest.mark.parametrize("native", READERS)
def test_checkpoint_resume_from_file(ll_matrix, ll_file, tmp_path, native):
    # the resume reads chunk 2 first: the native ring resets there
    ckpt = tmp_path / "loo.ckpt"

    class Stop(Exception):
        pass

    def bomb(done, total):
        if done == 2:
            raise Stop

    with pytest.raises(Stop):
        _quiet(tpl.loo_from_file, ll_file, native=native, chunk_size=16, dtype="float64",
               pointwise=True, checkpoint_path=str(ckpt), checkpoint_every=1, on_chunk=bomb)
    assert ckpt.exists()
    res = _quiet(tpl.loo_from_file, ll_file, native=native, chunk_size=16, dtype="float64",
                 pointwise=True, checkpoint_path=str(ckpt), checkpoint_every=1)
    assert not ckpt.exists()
    ref = _quiet(tpl.loo_streaming, _gen(ll_matrix), N_OBS, N_DRAWS, chunk_size=16,
                 dtype="float64", pointwise=True)
    assert res["elpd_loo"] == ref["elpd_loo"]
    assert_array_equal(res.loo_i.values, ref.loo_i.values)


@pytest.mark.parametrize("native", READERS)
def test_subsample_from_source(ll_matrix, ll_file, native):
    idx = np.sort(np.random.default_rng(5).choice(N_OBS, 30, replace=False))
    with NpyLogLik(ll_file, native=native) as src:
        res = _quiet(tpl.loo_subsample_streaming, src, N_OBS, N_DRAWS, observations=idx,
                     chunk_size=40, dtype="float64")
        jsrc = jpl.NpyLogLik(ll_file)
        ref = _quiet(jpl.loo_subsample_streaming, jsrc, N_OBS, N_DRAWS, observations=idx,
                     chunk_size=40, dtype=jnp.float64)
        jsrc.close()
    for key in ("elpd_loo", "se", "p_loo", "subsampling_SE"):
        assert_allclose(res[key], ref[key], err_msg=key, **F64)
    own = _quiet(tpl.loo_subsample_streaming, _gen(ll_matrix), N_OBS, N_DRAWS,
                 observations=idx, chunk_size=40, dtype="float64")
    assert res["elpd_loo"] == own["elpd_loo"]


@pytest.mark.parametrize("native", READERS)
def test_source_as_every_generator_argument(ll_matrix, ll_file, tmp_path, native):
    # e_loo_streaming's x_fn and loo_score_streaming's x_fn / x2_fn take a
    # source as log_lik_fn does; the same file serves two arguments at once
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N_OBS, N_DRAWS))
    x2 = rng.normal(size=(N_OBS, N_DRAWS))
    y = rng.normal(size=N_OBS)
    paths = {}
    for name, arr in (("x", x), ("x2", x2)):
        paths[name] = str(tmp_path / f"{name}.npy")
        np.save(paths[name], arr)
    with NpyLogLik(ll_file, native=native) as ll_src, \
            NpyLogLik(paths["x"], native=native) as x_src, \
            NpyLogLik(paths["x2"], native=native) as x2_src:
        got = tpl.e_loo_streaming(ll_src, x_src, N_OBS, N_DRAWS, type="variance",
                                  chunk_size=40, dtype="float64")
        want = tpl.e_loo_streaming(_gen(ll_matrix), _gen(x), N_OBS, N_DRAWS, type="variance",
                                   chunk_size=40, dtype="float64")
        assert_array_equal(got.value.values, want.value.values)
        assert_array_equal(got.pareto_k.values, want.pareto_k.values)
        jgot = jpl.e_loo_streaming(lambda i: jnp.asarray(ll_matrix)[i],
                                   lambda i: jnp.asarray(x)[i], N_OBS, N_DRAWS,
                                   type="variance", chunk_size=40, dtype=jnp.float64)
        assert_allclose(got.value.values, np.asarray(jgot.value.values), **F64)

        score = _quiet(tpl.loo_score_streaming, ll_src, x_src, x2_src, y, N_OBS, N_DRAWS,
                       permutations=2, seed=3, chunk_size=40, dtype="float64")
        jscore = _quiet(jpl.loo_score_streaming, jpl.NpyLogLik(ll_file),
                        jpl.NpyLogLik(paths["x"]), jpl.NpyLogLik(paths["x2"]), y, N_OBS,
                        N_DRAWS, permutations=2, seed=3, chunk_size=40, dtype=jnp.float64)
        assert_allclose(score.pointwise, np.asarray(jscore.pointwise), **F64)
        for field in ("Estimate", "SE"):
            assert_allclose(score.estimates[field], jscore.estimates[field], **F64)

        same = tpl.e_loo_streaming(ll_src, ll_src, N_OBS, N_DRAWS, chunk_size=40,
                                   dtype="float64")
        want = tpl.e_loo_streaming(_gen(ll_matrix), _gen(ll_matrix), N_OBS, N_DRAWS,
                                   chunk_size=40, dtype="float64")
        assert_array_equal(same.value.values, want.value.values)


@pytest.mark.parametrize("native", READERS)
def test_group_compare_and_approximate_posterior_from_source(ll_matrix, ll_file, native):
    groups = np.arange(N_OBS) % 9
    lp, lq = np.random.default_rng(2).normal(size=(2, N_DRAWS))
    with NpyLogLik(ll_file, native=native) as src:
        got = [
            _quiet(tpl.loo_group_streaming, src, groups, N_OBS, N_DRAWS, chunk_size=40,
                   dtype="float64")["elpd_logo"],
            _quiet(tpl.loo_approximate_posterior_streaming, src, lp, lq, N_OBS, N_DRAWS,
                   seed=1, chunk_size=40, dtype="float64")["elpd_loo"],
            _quiet(tpl.loo_compare_streaming, {"a": src, "b": _gen(ll_matrix - 0.1)}, N_OBS,
                   N_DRAWS, chunk_size=40, dtype="float64")["elpd_loo"],
        ]
    gen = _gen(ll_matrix)
    want = [
        _quiet(tpl.loo_group_streaming, gen, groups, N_OBS, N_DRAWS, chunk_size=40,
               dtype="float64")["elpd_logo"],
        _quiet(tpl.loo_approximate_posterior_streaming, gen, lp, lq, N_OBS, N_DRAWS,
               seed=1, chunk_size=40, dtype="float64")["elpd_loo"],
        _quiet(tpl.loo_compare_streaming, {"a": gen, "b": _gen(ll_matrix - 0.1)}, N_OBS,
               N_DRAWS, chunk_size=40, dtype="float64")["elpd_loo"],
    ]
    for g, w in zip(got, want):
        assert_array_equal(g, w)


def test_staging_buffers_alternate(ll_matrix, ll_file):
    # two staging buffers, chunks read in turn; on the CPU each chunk is a copy
    with NpyLogLik(ll_file) as src:
        chunks = _chunks.SourceChunks(src, 40, N_OBS, N_DRAWS, torch.float64,
                                      torch.device("cpu"), "log_lik_fn")
        first, second, third = chunks(0), chunks(1), chunks(2)
    assert_array_equal(first.numpy(), ll_matrix[:40])
    assert_array_equal(second.numpy(), ll_matrix[40:80])
    assert_array_equal(third.numpy(), ll_matrix[80:120])
    assert chunks._staging[0].data_ptr() != chunks._staging[1].data_ptr()
    assert not chunks._staging[0].is_pinned()  # pinned memory only for a CUDA device


def test_fallback_forced_by_env(ll_file, monkeypatch):
    monkeypatch.setattr(_native, "_lib", False)
    monkeypatch.setenv("PYLOO_TPU_NO_NATIVE", "1")
    src = NpyLogLik(ll_file)
    assert not src.is_native
    assert src.reads_issued is None
    with pytest.raises(RuntimeError, match="native=True"):
        NpyLogLik(ll_file, native=True)


def test_sequential_pass_reads_each_chunk_once(ll_file):
    # a sequential full pass issues exactly n_chunks preads, however far the
    # consumer runs ahead of the disk, and so does a streaming sweep
    chunk = 32
    n_chunks = -(-N_OBS // chunk)
    for trial in range(10):
        with NpyLogLik(ll_file, native=True, depth=3) as src:
            for c in range(n_chunks):
                src.read_rows(c * chunk, chunk)
            assert src.reads_issued == n_chunks, f"trial {trial}: {src.reads_issued} preads"
    with NpyLogLik(ll_file, native=True) as src:
        _quiet(tpl.loo_streaming, src, N_OBS, N_DRAWS, chunk_size=chunk, dtype="float64")
        assert src.reads_issued == n_chunks
