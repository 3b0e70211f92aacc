"""``pyloo_tpu_torch``'s multi-device layer against ``pyloo_tpu``'s on the CPU.

The port's CPU mesh is ``Mesh(("cpu",) * n)``: n shards on one device, each a
block of rows of its own, which runs the split, every shard's work and the
merge as over n cards.  ``obs_mesh()`` (the default mesh of ``apply_rowwise``,
``loo_nonfactor`` and moment matching) is made to see such a list by
replacing ``parallel.sharding._visible_devices``.  ``pyloo_tpu`` runs over a
``Mesh`` of as many of the 8 virtual CPU devices ``tests/conftest.py`` gives
it.

Per-row results are held bit for bit to the port's own run with no mesh,
and to ``pyloo_tpu`` within rtol and atol 1e-12 in float64 and 1e-5 in
float32.  The float64 deep-tail guard decides over ``pyloo_tpu``'s batches
(``ops/guard.py``), which the deep-tail cases check at every call site, with
the guard's host reads counted.  The streaming cases use chunks of
``64 n`` rows, so that every shard holds a multiple of 64 rows: the CPU's
elementwise kernels take a tensor in vector blocks and its ragged end one
element at a time, and the two can give a transcendental function's last bit
differently (``parallel.sharding._SHARD_ALIGN``).
"""

import importlib
import logging
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from numpy.testing import assert_allclose, assert_array_equal

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu import streaming as jstreaming
from pyloo_tpu.ops import loo_kernels as jlk
from pyloo_tpu.ops import psis as jpsis
from pyloo_tpu.parallel import sharding as jsharding
from pyloo_tpu_torch.ops import guard
from pyloo_tpu_torch.ops import loo_kernels as tlk
from pyloo_tpu_torch.ops import psis as tpsis
from pyloo_tpu_torch.ops import nonfactor as tnf
from pyloo_tpu_torch.ops import tail_length, topk
from pyloo_tpu_torch.parallel import Mesh, obs_mesh, sharding, witness
from pyloo_tpu_torch.streaming import _chunks

from .torch_parity import F64, synthetic

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
MESHES = [1, 2, 4, 8]

N, D, S = 1100, 5, 200
_rng = np.random.default_rng(11)
X = _rng.normal(size=(N, D))
Y = (_rng.random(N) < 0.5).astype(np.float64)
BETA = _rng.normal(scale=0.6, size=(S, D))
BETA[:20] *= 4.0  # a few wide draws give some rows heavy-tailed ratios
JAC = _rng.normal(scale=0.1, size=N)
PRED = _rng.normal(size=(N, S))
_Xj, _Yj, _Bj, _Jj, _Pj = map(jnp.asarray, (X, Y, BETA, JAC, PRED))
_Xt, _Yt, _Bt, _Jt, _Pt = map(torch.from_numpy, (X, Y, BETA, JAC, PRED))


def jax_ll(idx):
    eta = _Xj[idx] @ _Bj.T
    return _Yj[idx, None] * eta - jnp.logaddexp(eta, 0.0)


def torch_ll(idx):
    eta = _Xt[idx] @ _Bt.T
    return _Yt[idx, None] * eta - torch.logaddexp(eta, torch.zeros(()))


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def cpu_mesh(n):
    return Mesh(["cpu"] * n)


def jmesh(n):
    return JMesh(np.asarray(jax.devices()[:n]), ("obs",))


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def see_devices(monkeypatch, devices):
    """Make ``obs_mesh()`` see ``devices``, as on a machine with those cards."""
    monkeypatch.setattr(sharding, "_visible_devices", lambda: list(devices))


# -- the mesh ---------------------------------------------------------------


def test_obs_mesh_and_the_mesh_type(monkeypatch):
    see_devices(monkeypatch, [])
    assert obs_mesh() is None
    see_devices(monkeypatch, ["cpu"])
    assert obs_mesh() is None  # one device: no mesh, as in pyloo_tpu
    see_devices(monkeypatch, ["cpu"] * 4)
    with obs_mesh() as mesh:
        assert isinstance(mesh, Mesh) and mesh.size == 4
        assert mesh.devices == (torch.device("cpu"),) * 4
        assert mesh.axis_names == ("obs",)
    assert obs_mesh(["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    with pytest.raises(TypeError, match="mesh must be a pyloo_tpu_torch.parallel.Mesh"):
        sharding.as_mesh(jmesh(2), "loo_streaming")
    assert sharding.as_mesh(None, "x") is None


@pytest.mark.parametrize("n,shards", [(549, 8), (549, 3), (3, 8), (64, 2), (0, 4)])
def test_shard_bounds_cover_the_rows_in_order(n, shards):
    bounds = sharding.shard_bounds(n, shards)
    assert len(bounds) == shards and bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(start % 64 == 0 for start, stop in bounds if stop > start)
    assert sum(stop - start for start, stop in bounds) == n


# -- apply_rowwise ----------------------------------------------------------


def _rows(b, s, seed, dtype=np.float64):
    """Rows with some heavy tails, none so deep that a batch of them takes
    the float64 deep-tail branch (that case is ``_deep``'s)."""
    rng = np.random.default_rng(seed)
    ll = rng.normal(-1.0, 0.7, size=(b, s))
    ll[::37] = 0.8 * rng.standard_t(4, size=ll[::37].shape) - 1.0
    return ll.astype(dtype)


@pytest.mark.parametrize("n", MESHES)
def test_apply_rowwise_over_a_mesh_bitwise_and_against_pyloo_tpu(n):
    ll = _rows(549, 300, 3)  # 549 rows: the last shards are short or empty
    m = tail_length(300)
    x = torch.from_numpy(ll)
    none = sharding.apply_rowwise(lambda b: tlk.loo_scores_psis(b, m), x)
    got = sharding.apply_rowwise(lambda b: tlk.loo_scores_psis(b, m), x, mesh=cpu_mesh(n))
    want = jsharding.apply_rowwise(lambda b: jlk.loo_scores_psis(b, m), jnp.asarray(ll),
                                   n_outputs=3, mesh=jmesh(n))
    for g, a, w in zip(got, none, want):
        assert g.shape == (549,)
        assert_array_equal(g.numpy(), a.numpy())
        assert_allclose(g.numpy(), np.asarray(w), **F64)
    # float32 through the fast scorer (the kernel's plain version here)
    x32 = torch.from_numpy(ll.astype(np.float32))
    fast = lambda b: tlk.loo_scores_psis_fast(b, m)  # noqa: E731
    for g, a in zip(sharding.apply_rowwise(fast, x32, mesh=cpu_mesh(n)),
                    sharding.apply_rowwise(fast, x32)):
        assert_array_equal(g.numpy(), a.numpy())


def test_apply_rowwise_takes_the_default_mesh_of_its_inputs_kind(monkeypatch):
    x = torch.from_numpy(_rows(300, 50, 4))
    seen = []

    def kernel(b):
        seen.append(b.shape[0])
        return (b.sum(dim=1), b.amax(dim=1))

    see_devices(monkeypatch, ["cpu"] * 4)
    out = sharding.apply_rowwise(kernel, x)
    assert seen == [128, 128, 44]  # 300 rows over 4 shards of 128, one empty
    assert_array_equal(out[0].numpy(), x.sum(dim=1).numpy())
    seen.clear()
    # a mesh of CUDA devices leaves rows that lie on the CPU where they are
    see_devices(monkeypatch, [torch.device("cuda", 0), torch.device("cuda", 1)])
    sharding.apply_rowwise(kernel, x)
    assert seen == [300]


def _deep(b=256, s=1000, rows=(5,), seed=8):
    """Rows like ``_rows``' and, at ``rows``, a t(2) row whose quartile
    exceedance lies far below e^-60: a batch that holds one takes the
    float64 deep-tail branch, the signed-log fit, on every row."""
    rng = np.random.default_rng(seed)
    ll = rng.normal(-1, 0.7, size=(b, s))
    for r in rows:
        ll[r] = rng.standard_t(2, size=s) * 8.0 - 30.0
    return ll


@pytest.fixture
def reads(monkeypatch):
    """The deep-tail guard's host reads, counted."""
    count = [0]
    real = guard.host_read

    def counted(flags):
        count[0] += 1
        return real(flags)

    monkeypatch.setattr(guard, "host_read", counted)
    return count


def test_deep_tail_guard_takes_both_branches_under_a_mesh():
    # row 5 is deep in its tail.  pyloo_tpu decides the guard over its whole
    # sharded call, so every row of every shard takes the signed-log fit, as
    # every row does with no mesh, where the 256 rows are one of pyloo_tpu's
    # chunks.  (Shards deciding alone put Pareto k 8.2e-12 apart.)
    ll = _deep()
    m = tail_length(1000)
    x = torch.from_numpy(ll)
    none = sharding.apply_rowwise(lambda b: tlk.loo_scores_psis(b, m), x)
    got = sharding.apply_rowwise(lambda b: tlk.loo_scores_psis(b, m), x, mesh=cpu_mesh(4))
    want = jsharding.apply_rowwise(lambda b: jlk.loo_scores_psis(b, m), jnp.asarray(ll),
                                   n_outputs=3, mesh=jmesh(4))
    for g, a, w in zip(got, none, want):
        assert_array_equal(g.numpy(), a.numpy())
        assert_allclose(g.numpy(), np.asarray(w), **F64)


def _psis_both(m):
    """(port, pyloo_tpu) row functions of both float64 fit sites: the
    scorer's and the weights'."""
    return ((lambda b: tlk.loo_scores_psis(b, m) + tpsis.psislw_batch(-b, m)),
            (lambda b: jlk.loo_scores_psis(b, m) + jpsis.psislw_batch(-b, m)))


@pytest.mark.parametrize("n", MESHES)
def test_deep_tail_guard_decides_over_the_whole_call_under_a_mesh(n, reads):
    ll = _deep(rows=(5, 200))  # two deep rows, on shards of their own from n = 4 on
    m = tail_length(1000)
    tfn, jfn = _psis_both(m)
    x = torch.from_numpy(ll)
    none = sharding.apply_rowwise(tfn, x)
    reads[0] = 0
    got = sharding.apply_rowwise(tfn, x, mesh=cpu_mesh(n))
    assert reads[0] == 1  # one decision group, one read, after every shard is queued
    want = jsharding.apply_rowwise(jfn, jnp.asarray(ll), n_outputs=5, mesh=jmesh(n))
    for g, a, w in zip(got, none, want):
        assert_array_equal(g.numpy(), a.numpy())
        assert_allclose(g.numpy(), np.asarray(w), **F64)


@pytest.mark.parametrize("group_rows", [None, 100])
def test_deep_tail_guard_decides_over_pyloo_tpus_chunks(monkeypatch, reads, group_rows):
    """No mesh: the groups are pyloo_tpu's chunks of rows, whatever chunks
    the port's budget runs (here 64 rows).  ``group_rows`` 100 cuts
    pyloo_tpu's chunks at 100 rows, so the port's chunk 64:128 holds rows of
    a deep group and of a shallow one."""
    monkeypatch.setattr(jsharding, "obs_mesh", lambda *a, **k: None)
    ll = _deep(rows=(5, 150))  # groups 0:100 and 100:200 are deep, 200:256 is not
    m = tail_length(1000)
    tfn, jfn = _psis_both(m)
    jkw = {}
    if group_rows is not None:
        monkeypatch.setattr(sharding, "_GUARD_CHUNK_BYTES", group_rows * 1000 * 8)
        jkw["chunk_bytes"] = group_rows * 1000 * 8
    budget = sharding._LIVE_ROW_BUFFERS * 64 * 1000 * 8
    got = sharding.apply_rowwise(tfn, torch.from_numpy(ll), chunk_bytes=budget)
    assert reads[0] == 1
    want = jsharding.apply_rowwise(jfn, jnp.asarray(ll), n_outputs=5, **jkw)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **F64)
    if group_rows is not None:  # the shallow group took the linear fit: its k differs
        whole = sharding.apply_rowwise(tfn, torch.from_numpy(ll), mesh=cpu_mesh(1))
        assert not torch.equal(got[1][200:], whole[1][200:])
        assert_array_equal(got[1][:200].numpy(), whole[1][:200].numpy())


def test_deep_tail_guard_reads_nothing_in_float32_and_once_a_call_in_float64(reads):
    m = tail_length(1000)
    x = torch.from_numpy(_rows(300, 1000, 4))
    fast = lambda b: tlk.loo_scores_psis_fast(b, m)  # noqa: E731
    sharding.apply_rowwise(fast, x.float(), mesh=cpu_mesh(4))
    sharding.apply_rowwise(lambda b: tlk.loo_scores_sis(b), x, mesh=cpu_mesh(4))
    assert reads[0] == 0
    sharding.apply_rowwise(lambda b: tlk.loo_scores_psis(b, m), x, mesh=cpu_mesh(4))
    assert reads[0] == 1
    tlk.loo_scores_psis(x, m)  # a direct call decides over its own batch
    assert reads[0] == 2


def test_guard_groups_are_pyloo_tpus_batches():
    assert sharding.guard_groups(262_144, 4000, 8, None) == [
        (0, 67_108), (67_108, 134_216), (134_216, 201_324), (201_324, 262_144)]
    assert sharding.guard_groups(262_144, 4000, 8, cpu_mesh(4)) == [(0, 262_144)]
    assert sharding.guard_groups(65_536, 4000, 8, None) == [(0, 65_536)]
    assert sharding.guard_groups(10, 2 << 30, 8, None) == [(a, a + 1) for a in range(10)]


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("n", [2, 8])
def test_loo_shards_by_default_and_matches_pyloo_tpu(monkeypatch, precision, n):
    # float64: no row deep enough in its tail to switch the deep-tail guard
    jid, tid = synthetic(obs_shape=(300,), draws=200, tail=precision == "float32")
    jpl.rcParams["device.precision"] = tpl.rcParams["device.precision"] = precision
    try:
        none = _quiet(tpl.loo, tid, pointwise=True)
        see_devices(monkeypatch, ["cpu"] * n)
        got = _quiet(tpl.loo, tid, pointwise=True)
        want = _quiet(jpl.loo, jid, pointwise=True)  # over pyloo_tpu's 8-device mesh
    finally:
        jpl.rcParams["device.precision"] = tpl.rcParams["device.precision"] = "float64"
    assert_array_equal(got.loo_i.values, none.loo_i.values)
    assert_array_equal(got.pareto_k.values, none.pareto_k.values)
    tol = F64 if precision == "float64" else F32
    assert_allclose(got.loo_i.values, want.loo_i.values, **tol)
    for key in ("elpd_loo", "p_loo", "se"):
        assert_allclose(got[key], want[key], **tol)


# -- the streaming entry points ---------------------------------------------


@pytest.mark.parametrize("chunk,n_obs,n_draws", [(None, 1000, 100), (None, 1100, 4000),
                                                 (100, 1000, 50), (5, 1000, 50),
                                                 (None, 7, 30)])
@pytest.mark.parametrize("n", [3, 8])
def test_resolve_chunk_under_a_mesh_equals_pyloo_tpu(chunk, n_obs, n_draws, n):
    for dtype in ("float32", "float64"):
        want = jstreaming._resolve_chunk(chunk, n_obs, n_draws, np.dtype(dtype), jmesh(n))
        got = _chunks.resolve_chunk(chunk, n_obs, n_draws, getattr(torch, dtype),
                                    mesh=cpu_mesh(n))
        assert got == want


def test_shards_split_and_gather_in_row_order():
    shards = _chunks.Shards(cpu_mesh(4), 64, 3, 150, torch.device("cpu"))
    host = np.arange(192.0)
    bufs = shards.split(host, torch.float64)
    assert [b.shape for b in bufs] == [(48,)] * 4
    assert_array_equal(bufs[1][:16].numpy(), np.arange(16.0, 32.0))  # chunk 0, shard 1
    assert_array_equal(shards.host(bufs), host[:150])
    idx, valid = shards.indices(2, 3)
    assert_array_equal(idx.numpy(), np.minimum(np.arange(176, 192), 149))
    assert valid.sum() == 0


def _loo_case(variant, tmp_path):
    """(port generator, pyloo_tpu generator, port and pyloo_tpu keywords)."""
    if variant == "source":
        path = tmp_path / "ll.npy"
        np.save(path, np.asarray(jax_ll(jnp.arange(N))))
        return tpl.NpyLogLik(str(path)), jpl.NpyLogLik(str(path)), {}, {}
    if variant == "jacobian":
        return (torch_ll, jax_ll, dict(jacobian_fn=lambda i: _Jt[i], scale="deviance"),
                dict(jacobian_fn=lambda i: _Jj[i], scale="deviance"))
    if variant == "mixture":
        return torch_ll, jax_ll, dict(mixture=True), dict(mixture=True)
    return torch_ll, jax_ll, {}, {}


@pytest.mark.parametrize("variant", ["generator", "mixture", "jacobian", "source"])
@pytest.mark.parametrize("n", MESHES)
def test_loo_streaming_over_a_mesh(n, variant, tmp_path):
    tgen, jgen, tkw, jkw = _loo_case(variant, tmp_path)
    common = dict(chunk_size=64 * n, pointwise=True, dtype="float64")
    none = _quiet(tpl.loo_streaming, tgen, N, S, **common, **tkw)
    got = _quiet(tpl.loo_streaming, tgen, N, S, mesh=cpu_mesh(n), **common, **tkw)
    want = _quiet(jpl.loo_streaming, jgen, N, S, mesh=jmesh(n), **common, **jkw)
    if variant == "mixture":
        # elpd_i = log_norm - log_obs_i: the normaliser is a log-sum-exp over
        # every row, summed shard by shard, so all rows move with its last bit
        assert_allclose(got.loo_i.values, none.loo_i.values, **F64)
    else:
        assert_array_equal(got.loo_i.values, none.loo_i.values)
    assert_array_equal(got.pareto_k.values, none.pareto_k.values)
    assert_allclose(got.loo_i.values, want.loo_i.values, **F64)
    for key in ("elpd_loo", "se") + (() if variant == "mixture" else ("p_loo",)):
        assert_allclose(got[key], none[key], **F64)
        assert_allclose(got[key], want[key], **F64)
    assert str(got) == str(want)


def test_loo_streaming_float32_over_a_mesh():
    kw = dict(chunk_size=256, pointwise=True, dtype="float32")
    none = _quiet(tpl.loo_streaming, torch_ll, N, S, **kw)
    got = _quiet(tpl.loo_streaming, torch_ll, N, S, mesh=cpu_mesh(4), **kw)
    want = _quiet(jpl.loo_streaming, jax_ll, N, S, mesh=jmesh(4), **kw)
    assert_array_equal(got.loo_i.values, none.loo_i.values)
    assert_array_equal(got.pareto_k.values, none.pareto_k.values)
    assert got.fast_path_degenerate == none.fast_path_degenerate
    assert_allclose(got["elpd_loo"], want["elpd_loo"], **F32)
    assert_allclose(got.loo_i.values, want.loo_i.values, **F32)


_DEEP = _deep(b=512, rows=(5, 300))
_DEEP_T, _DEEP_J = torch.from_numpy(_DEEP), jnp.asarray(_DEEP)


@pytest.mark.parametrize("n", MESHES)
def test_loo_streaming_deep_tail_over_a_mesh(n, reads):
    # chunks of 64 n rows: one chunk at n = 8, and at n = 1 chunks 0 and 4
    # deep and the others not; each chunk is one decision, across its shards
    common = dict(chunk_size=64 * n, pointwise=True, dtype="float64")
    none = _quiet(tpl.loo_streaming, lambda i: _DEEP_T[i], 512, 1000, **common)
    reads[0] = 0
    got = _quiet(tpl.loo_streaming, lambda i: _DEEP_T[i], 512, 1000, mesh=cpu_mesh(n),
                 **common)
    assert reads[0] == 512 // (64 * n)  # one read a chunk, not one a shard
    want = _quiet(jpl.loo_streaming, lambda i: _DEEP_J[i], 512, 1000, mesh=jmesh(n), **common)
    assert_array_equal(got.loo_i.values, none.loo_i.values)
    assert_array_equal(got.pareto_k.values, none.pareto_k.values)
    assert_allclose(got.loo_i.values, want.loo_i.values, **F64)
    assert_allclose(got.pareto_k.values, want.pareto_k.values, **F64)
    for key in ("elpd_loo", "se", "p_loo"):
        assert_allclose(got[key], want[key], **F64)


def test_loo_streaming_checkpoint_resumes_under_a_mesh(tmp_path):
    path = str(tmp_path / "ck.npz")
    kw = dict(chunk_size=128, pointwise=True, dtype="float64", mesh=cpu_mesh(2),
              checkpoint_path=path, checkpoint_every=2)
    whole = _quiet(tpl.loo_streaming, torch_ll, N, S, **{**kw, "checkpoint_path": None})

    def stop(c, total):
        if c == 5:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _quiet(tpl.loo_streaming, torch_ll, N, S, on_chunk=stop, **kw)
    # the file is a run's with no mesh: it resumes without one too
    resumed = _quiet(tpl.loo_streaming, torch_ll, N, S, **{**kw, "mesh": None})
    assert_array_equal(resumed.loo_i.values, whole.loo_i.values)
    assert_allclose(resumed["elpd_loo"], whole["elpd_loo"], **F64)


def test_generator_on_another_device_names_the_contract():
    def on_card_zero(idx):
        raise RuntimeError("Expected all tensors to be on the same device, but found at"
                           " least two devices, cuda:0 and cuda:1!")

    with pytest.raises(RuntimeError, match="keyed on idx.device"):
        tpl.loo_streaming(on_card_zero, N, S, mesh=cpu_mesh(2))


def _both8(n=8):
    return dict(chunk_size=64 * n, mesh=cpu_mesh(n)), dict(chunk_size=64 * n, mesh=jmesh(n))


def test_waic_streaming_over_a_mesh():
    tkw, jkw = _both8()
    none = _quiet(tpl.waic_streaming, torch_ll, N, S, pointwise=True, dtype="float64",
                  chunk_size=512)
    got = _quiet(tpl.waic_streaming, torch_ll, N, S, pointwise=True, dtype="float64", **tkw)
    want = _quiet(jpl.waic_streaming, jax_ll, N, S, pointwise=True, dtype="float64", **jkw)
    assert_array_equal(got["waic_i"].values, none["waic_i"].values)
    for key in ("elpd_waic", "se", "p_waic"):
        assert_allclose(got[key], want[key], **F64)
    assert str(got) == str(want)


@pytest.mark.parametrize("method", ["psis", "sis"])
def test_loo_group_streaming_over_a_mesh(method):
    groups = np.arange(N) % 37
    tkw, jkw = _both8()
    none = _quiet(tpl.loo_group_streaming, torch_ll, groups, N, S, pointwise=True,
                  method=method, dtype="float64", chunk_size=512)
    got = _quiet(tpl.loo_group_streaming, torch_ll, groups, N, S, pointwise=True,
                 method=method, dtype="float64", **tkw)
    want = _quiet(jpl.loo_group_streaming, jax_ll, groups, N, S, pointwise=True,
                  method=method, dtype="float64", **jkw)
    # a group's rows lie on several devices and are summed in another order
    assert_allclose(got["logo_i"].values, none["logo_i"].values, **F64)
    assert_allclose(got["logo_i"].values, want["logo_i"].values, **F64)
    assert_allclose(got["elpd_logo"], want["elpd_logo"], **F64)


@pytest.mark.parametrize("kind,probs", [("mean", None), ("sd", None), ("quantile", [0.1, 0.5])])
def test_e_loo_streaming_over_a_mesh(kind, probs):
    tkw, jkw = _both8()
    args = dict(type=kind, probs=probs, dtype="float64")
    none = _quiet(tpl.e_loo_streaming, torch_ll, lambda i: _Pt[i], N, S, chunk_size=512,
                  **args)
    got = _quiet(tpl.e_loo_streaming, torch_ll, lambda i: _Pt[i], N, S, **tkw, **args)
    want = _quiet(jpl.e_loo_streaming, jax_ll, lambda i: _Pj[i], N, S, **jkw, **args)
    assert_array_equal(got.value.values, none.value.values)
    assert_array_equal(got.pareto_k.values, none.pareto_k.values)
    assert_allclose(got.value.values, np.asarray(want.value.values), **F64)
    assert_allclose(got.pareto_k.values, np.asarray(want.pareto_k.values), **F64)
    metric = _quiet(tpl.loo_predictive_metric_streaming, torch_ll, lambda i: _Pt[i], Y, N, S,
                    dtype="float64", **tkw)
    jmetric = _quiet(jpl.loo_predictive_metric_streaming, jax_ll, lambda i: _Pj[i], Y, N, S,
                     dtype="float64", **jkw)
    assert_allclose(metric["estimate"], jmetric["estimate"], **F64)


@pytest.mark.parametrize("estimator", ["diff_srs", "hh_pps"])
def test_loo_subsample_streaming_over_a_mesh(estimator):
    tkw, jkw = _both8()
    args = dict(observations=60, estimator=estimator, pointwise=True, dtype="float64", seed=3)
    none = _quiet(tpl.loo_subsample_streaming, torch_ll, N, S, chunk_size=512, **args)
    got = _quiet(tpl.loo_subsample_streaming, torch_ll, N, S, **tkw, **args)
    want = _quiet(jpl.loo_subsample_streaming, jax_ll, N, S, **jkw, **args)
    assert_array_equal(got.estimates.stream["elpd_loo_approximation"],
                       none.estimates.stream["elpd_loo_approximation"])
    assert_array_equal(got.loo_i.values, none.loo_i.values)
    for key in ("elpd_loo", "se", "subsampling_SE"):
        assert_allclose(got[key], want[key], **F64)
    # an update goes through the same mesh
    upd = _quiet(tpl.update_subsample, got, observations=90, seed=5)
    jupd = _quiet(jpl.update_subsample, want, observations=90, seed=5)
    assert_allclose(upd["elpd_loo"], jupd["elpd_loo"], **F64)


def test_loo_score_streaming_over_a_mesh():
    tkw, jkw = _both8()
    x2 = lambda i: _Pt[i] * 0.9 + 0.1  # noqa: E731
    jx2 = lambda i: _Pj[i] * 0.9 + 0.1  # noqa: E731
    args = dict(permutations=2, seed=4, dtype="float64")
    none = _quiet(tpl.loo_score_streaming, torch_ll, lambda i: _Pt[i], x2, Y, N, S,
                  chunk_size=512, **args)
    got = _quiet(tpl.loo_score_streaming, torch_ll, lambda i: _Pt[i], x2, Y, N, S, **tkw,
                 **args)
    want = _quiet(jpl.loo_score_streaming, jax_ll, lambda i: _Pj[i], jx2, Y, N, S, **jkw,
                  **args)
    assert_array_equal(got.pointwise, none.pointwise)
    assert_allclose(got.pointwise, want.pointwise, **F64)
    assert_allclose(got.estimates["Estimate"], want.estimates["Estimate"], **F64)


def test_loo_compare_and_approximate_posterior_streaming_over_a_mesh():
    tkw, jkw = _both8()
    worse_t = lambda i: torch_ll(i) - 0.05  # noqa: E731
    worse_j = lambda i: jax_ll(i) - 0.05  # noqa: E731
    got = _quiet(tpl.loo_compare_streaming, {"a": torch_ll, "b": worse_t}, N, S,
                 dtype="float64", **tkw)
    want = _quiet(jpl.loo_compare_streaming, {"a": jax_ll, "b": worse_j}, N, S,
                  dtype="float64", **jkw)
    assert_allclose(np.asarray(got["elpd_loo"]), np.asarray(want["elpd_loo"]), **F64)
    lp, lq = np.random.default_rng(5).normal(size=(2, S))
    args = dict(seed=1, pointwise=True, dtype="float64")
    none = _quiet(tpl.loo_approximate_posterior_streaming, torch_ll, lp, lq, N, S,
                  chunk_size=512, **args)
    got = _quiet(tpl.loo_approximate_posterior_streaming, torch_ll, lp, lq, N, S, **tkw,
                 **args)
    want = _quiet(jpl.loo_approximate_posterior_streaming, jax_ll, lp, lq, N, S, **jkw,
                  **args)
    assert_array_equal(got.loo_i.values, none.loo_i.values)
    assert_allclose(got["elpd_loo"], want["elpd_loo"], **F64)


def test_loo_from_file_and_warmup_pass_the_mesh_on(tmp_path):
    path = tmp_path / "ll.npy"
    np.save(path, np.asarray(jax_ll(jnp.arange(N))))
    tkw, jkw = _both8(4)
    got = _quiet(tpl.loo_from_file, str(path), dtype="float64", pointwise=True, **tkw)
    want = _quiet(jpl.loo_from_file, str(path), dtype="float64", pointwise=True, **jkw)
    assert_allclose(got.loo_i.values, want.loo_i.values, **F64)
    wtkw = _quiet(tpl.waic_from_file, str(path), dtype="float64", **tkw)
    assert_allclose(wtkw["elpd_waic"], _quiet(jpl.waic_from_file, str(path), dtype="float64",
                                              **jkw)["elpd_waic"], **F64)
    res = tpl.warmup(N, S, dtype="float64", mesh=cpu_mesh(4))
    assert res["chunk_size"] == _chunks.resolve_chunk(None, N, S, torch.float64,
                                                      mesh=cpu_mesh(4))[0]


# -- draws and lanes --------------------------------------------------------


@pytest.mark.parametrize("model_type,form", [("normal", "cov"), ("normal", "prec"),
                                             ("student_t", "cov")])
def test_loo_nonfactor_deals_its_chunks_over_the_mesh(monkeypatch, model_type, form):
    rng = np.random.default_rng(42)
    n, chains, draws = 10, 2, 60
    a = rng.normal(size=(n, n)) * 0.3
    cov = a @ a.T + np.eye(n)
    y = rng.multivariate_normal(np.zeros(n), cov)
    mus = rng.normal(0, 0.05, size=(chains, draws, n))
    covs = np.broadcast_to(cov, (chains, draws, n, n)).copy()
    covs += 0.01 * rng.normal(size=(chains, draws, n, n)) * np.eye(n)
    mats = covs if form == "cov" else np.linalg.inv(covs)
    post = {"mu": mus, form: mats, "df": np.full((chains, draws), 6.0)}
    tid = tpl.from_dict(posterior=post, observed_data={"y": y})
    jid = jpl.from_dict(posterior=post, observed_data={"y": y})
    kw = dict(pointwise=True, reff=1.0, model_type=model_type)
    if form == "prec":
        kw.update(cov_var_name=None, prec_var_name="prec")
    # seven draws a chunk: 18 chunks dealt over the 4 shards in turn
    monkeypatch.setattr(tnf, "_CHUNK_BUDGET_BYTES", 7 * tnf._MATRICES_PER_DRAW * 8 * n * n)
    single = _quiet(tpl.loo_nonfactor, tid, **kw)
    see_devices(monkeypatch, ["cpu"] * 4)
    meshes = []
    real = tnf._by_chunks
    monkeypatch.setattr(tnf, "_by_chunks",
                        lambda *a: meshes.append(a[-1]) or real(*a))
    got = _quiet(tpl.loo_nonfactor, tid, **kw)
    assert meshes and meshes[0].size == 4
    tpl.rcParams["device.auto_shard"] = False
    try:
        _quiet(tpl.loo_nonfactor, tid, **kw)
    finally:
        tpl.rcParams["device.auto_shard"] = True
    assert meshes[-1] is None  # auto_shard off: one device
    want = _quiet(jpl.loo_nonfactor, jid, **kw)
    assert_array_equal(got.loo_i.values, single.loo_i.values)
    assert_array_equal(got.pareto_k.values, single.pareto_k.values)
    assert_allclose(got.loo_i.values, want.loo_i.values, **F64)
    assert_allclose(got["elpd_loo"], want["elpd_loo"], **F64)


@pytest.fixture(scope="module")
def mm_fitted():
    """``tests/test_torch_moment_match.py``'s model and fit."""
    from . import test_torch_moment_match as tmm

    jm = tmm.jwrap.Model("ls", {"y": tmm.Y}, tmm.SHAPES, tmm._jlogp, tmm._jll, obs_keys=("y",))
    tm = tmm.twrap.Model("ls", {"y": tmm.Y}, tmm.SHAPES, tmm._tlogp, tmm._tll, obs_keys=("y",))
    jid = tmm.jwrap.fit(jm, draws=500, tune=500, chains=2, seed=7)
    tid = tmm.twrap.idata_from_flat_draws(tm, np.array(jid.sample_stats._flat_draws.values))
    jloo = _quiet(jpl.loo, jid, pointwise=True, reff=1.0)
    tloo = _quiet(tpl.loo, tid, pointwise=True, reff=1.0)
    return jpl.JAXModelWrapper(jm, jid), tpl.JAXModelWrapper(tm, tid), jloo, tloo


def test_moment_matching_splits_its_lanes_over_the_mesh(monkeypatch, mm_fitted):
    jw, tw, jloo, tloo = mm_fitted
    mm_module = importlib.import_module("pyloo_tpu_torch.loo_moment_match")
    kw = dict(split=False, cov=True, k_threshold=0.3, max_iters=5, device_batched=True)
    logging.disable(logging.INFO)
    try:
        tpl.rcParams["device.auto_shard"] = False
        try:
            single = _quiet(tpl.loo_moment_match, tw, tloo, **kw)
        finally:
            tpl.rcParams["device.auto_shard"] = True
        see_devices(monkeypatch, ["cpu"] * 8)
        lanes = []
        real = mm_module._Lanes

        class Spy(real):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                lanes.append(args[1].shape[0])

        monkeypatch.setattr(mm_module, "_Lanes", Spy)
        got = _quiet(tpl.loo_moment_match, tw, tloo, **kw)
        want = _quiet(jpl.loo_moment_match, jw, jloo, **kw)  # over its 8-device mesh
    finally:
        logging.disable(logging.NOTSET)
    n_bad = int(np.sum(tloo.pareto_k.values > 0.3))
    # every group's lanes are split in 8 equal sets, padded where the group
    # is not a multiple of 8 with lanes that never run
    assert len(lanes) % 8 == 0 and sum(lanes) >= n_bad and sum(lanes) % 8 == 0
    assert sum(lanes) > n_bad
    assert got.moment_match_passes >= 1
    assert_allclose(got.loo_i.values, single.loo_i.values, **F64)
    assert_allclose(got.pareto_k.values, single.pareto_k.values, **F64)
    # a lane whose ratios flattened carries the packages' last bits of log_prob
    # into k by ~1e-11, no guard involved (ROADMAP Queue 3 item 39, tested in
    # test_torch_moment_match.py::test_a_near_flat_tail_carries_the_last_bit_of_its_ratios_into_k)
    assert_allclose(got.loo_i.values, want.loo_i.values, rtol=1e-10, atol=1e-10)
    assert_allclose(got.pareto_k.values, want.pareto_k.values, rtol=1e-10, atol=1e-10)


# -- the witness ------------------------------------------------------------


def _copy(kind, nbytes, **args):
    names = {"peer": "Memcpy PtoP (Device -> Device)", "dtod": "Memcpy DtoD (Device -> Device)",
             "dtoh": "Memcpy DtoH (Device -> Pinned)", "htod": "Memcpy HtoD (Pinned -> Device)"}
    return {"name": names[kind], "cat": "gpu_memcpy", "args": {"bytes": nbytes, **args}}


def test_transfer_census_sorts_copies_and_allows_scalars_only():
    events = [
        _copy("htod", 4096), _copy("dtoh", 8000), _copy("dtoh", 8),
        _copy("dtod", 1 << 20, **{"src device": 0, "dst device": 0}),
        _copy("peer", 8), _copy("peer", 64),
        {"name": "loo_prepass_kernel<true, 8>", "cat": "kernel", "args": {}},
    ]
    census = witness.census_of(events)
    assert census == {"peer": [8, 64], "device_to_device": [1 << 20],
                      "device_to_host": [8000, 8], "host_to_device": [4096]}
    assert witness.assert_scalar_only_transfers(census) is census


@pytest.mark.parametrize("bad", [
    _copy("peer", 8 * 1024),  # per-row outputs handed from card to card
    _copy("dtod", 4096, **{"src device": 0, "dst device": 1}),  # a DtoD between two cards
])
def test_transfer_census_rejects_rows_between_cards(bad):
    census = witness.census_of([_copy("peer", 8), bad])
    assert len(census["peer"]) == 2
    with pytest.raises(AssertionError, match="larger than 64 bytes"):
        witness.assert_scalar_only_transfers(census)


def test_launch_census_and_flat_weak_scaling(monkeypatch):
    monkeypatch.setattr(topk.loo_prepass, "by_device", {"cuda:0": 3})
    monkeypatch.setattr(topk.topk_desc, "by_device", {v: {} for v in topk.TOPK_VARIANTS})

    def launch(per_device):
        for device, n in per_device.items():
            for _ in range(n):
                topk._count_on(topk.loo_prepass.by_device, torch.device(device))

    monkeypatch.setattr(topk, "_cuda_device", lambda d: torch.device(d))
    out, launches = witness.launch_census(lambda: launch({"cuda:0": 2, "cuda:1": 2}) or "ok")
    assert out == "ok" and launches == {"cuda:0": 2, "cuda:1": 2}
    runs = {1: [2], 2: [2, 2], 4: [2, 2, 2, 2]}
    assert witness.assert_flat_weak_scaling(runs) is runs
    with pytest.raises(AssertionError, match="differ across mesh sizes"):
        witness.assert_flat_weak_scaling({1: [2], 2: [2, 3]})
