"""``pyloo_tpu_torch.loo_streaming`` against ``pyloo_tpu.loo_streaming`` on the CPU.

One seeded numpy logistic regression (X, y, beta from
``np.random.default_rng``) goes through both packages: a ``jnp`` generator
for ``pyloo_tpu`` and a ``torch`` generator for the port, each computing
``y * eta - logaddexp(eta, 0)`` with ``eta = X[idx] @ beta.T`` for the
chunk's rows.  Float64 results agree within rtol and atol 1e-12 and print
byte for byte alike (the two generators round their matrix products and
``logaddexp`` in their own libraries); float32 results within rtol and atol
1e-5.  203 observations in chunks of 64 leave a ragged last chunk.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from pyloo_tpu import streaming as jstreaming
from pyloo_tpu_torch.ops import topk
from pyloo_tpu_torch.streaming import _checkpoint, _chunks

N, D, S = 203, 5, 400
CHUNK = 64
F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-5, atol=1e-5)

_rng = np.random.default_rng(2024)
X = _rng.normal(size=(N, D))
Y = (_rng.random(N) < 0.5).astype(np.float64)
BETA = _rng.normal(scale=0.6, size=(S, D))
BETA[:40] *= 4.0  # a few wide draws give some rows heavy-tailed ratios
JAC = _rng.normal(scale=0.1, size=N)

_Xj, _Yj, _Bj, _Jj = map(jnp.asarray, (X, Y, BETA, JAC))
_Xt, _Yt, _Bt, _Jt = map(torch.from_numpy, (X, Y, BETA, JAC))


def jax_ll(idx):
    eta = _Xj[idx] @ _Bj.T
    return _Yj[idx, None] * eta - jnp.logaddexp(eta, 0.0)


def torch_ll(idx):
    eta = _Xt[idx] @ _Bt.T
    return _Yt[idx, None] * eta - torch.logaddexp(eta, torch.zeros(()))


def jax_jac(idx):
    return _Jj[idx]


def torch_jac(idx):
    return _Jt[idx]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def _both(dtype="float64", jax_kw=None, torch_kw=None, **kw):
    """The same streaming call through both packages, warnings recorded."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jres = jpl.loo_streaming(jax_ll, N, S, dtype=getattr(jnp, dtype),
                                 **kw, **(jax_kw or {}))
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        tres = tpl.loo_streaming(torch_ll, N, S, dtype=dtype, **kw, **(torch_kw or {}))
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    return tres, jres, [str(w.message) for w in tw]


def _assert_same(tres, jres, tol=F64, tols=None):
    assert list(tres.index) == list(jres.index)
    for key in tres.index:
        t, j = tres[key], jres[key]
        tol = (tols or {}).get(key, tol)
        if hasattr(t, "values"):
            assert t.dims == j.dims
            assert_allclose(t.values, j.values, **tol, err_msg=key)
        elif isinstance(t, (float, np.floating)):
            assert_allclose(t, j, **tol, err_msg=key)
        else:
            assert t == j, key
    assert tres.fast_path_degenerate == jres.fast_path_degenerate


@pytest.mark.parametrize("method", ["psis", "sis", "tis"])
def test_float64_matches_and_prints_alike(method):
    tres, jres, _ = _both(method=method, chunk_size=CHUNK, pointwise=True)
    _assert_same(tres, jres)
    assert str(tres) == str(jres)
    assert tres.loo_i.values.shape == (N,)


def test_float64_pareto_warning_and_summary_only():
    tres, jres, msgs = _both(chunk_size=CHUNK)
    _assert_same(tres, jres)
    assert str(tres) == str(jres)
    assert any("Pareto" in m for m in msgs) and bool(tres["warning"])


def test_float32_within_1e5():
    before = (topk.loo_prepass.launches, dict(topk.topk_desc.launches))
    tres, jres, _ = _both("float32", chunk_size=CHUNK, pointwise=True)
    _assert_same(tres, jres, F32)
    assert tres.loo_i.values.dtype == np.float32
    # the CPU runs the plain versions: no kernel launch is counted
    assert (topk.loo_prepass.launches, topk.topk_desc.launches) == before


@pytest.mark.parametrize("jacobian", [False, True])
def test_mixture(jacobian):
    kw = dict(chunk_size=CHUNK, pointwise=True, mixture=True)
    tres, jres, msgs = _both(
        jax_kw={"jacobian_fn": jax_jac} if jacobian else None,
        torch_kw={"jacobian_fn": torch_jac} if jacobian else None,
        **kw,
    )
    # without a Jacobian every log_obs_i is logsumexp(-ll - c_i) = 0 exactly, so
    # the SE is sqrt(n * var) of a float64 cancellation residue (~1e-15): both
    # packages give 0 to within 1e-6, and the report prints 0.00 alike
    _assert_same(tres, jres, tols=None if jacobian else {"se": dict(rtol=0, atol=1e-6)})
    assert str(tres) == str(jres)
    assert any("Mix-IS-LOO requires" in m for m in msgs)
    assert ("p_loo" in tres.index) == jacobian


def test_jacobian_and_deviance_scale():
    tres, jres, _ = _both(chunk_size=CHUNK, pointwise=True, scale="deviance",
                          jax_kw={"jacobian_fn": jax_jac}, torch_kw={"jacobian_fn": torch_jac})
    _assert_same(tres, jres)
    assert str(tres) == str(jres)
    assert tres["scale"] == "deviance"


def test_column_gather_and_default_chunking():
    perm = np.random.default_rng(3).integers(0, S, size=S)
    tres, jres, _ = _both(pointwise=True, _column_gather=perm)
    _assert_same(tres, jres)
    # one chunk holds all 203 rows, rounded up to 208
    assert _chunks.resolve_chunk(None, N, S, torch.float64) == (208, 1)


@pytest.mark.parametrize(
    "chunk_size, n_obs, n_draws, dtype",
    [(None, 1_000_000, 4_000, "float32"), (None, 250_000, 4_000, "float64"),
     (None, 7, 10, "float64"), (100, 1_000, 50, "float32"), (3, 1_000, 50, "float32"),
     (5_000, 1_000, 50, "float64")],
)
def test_chunk_geometry_matches(chunk_size, n_obs, n_draws, dtype):
    want = jstreaming._resolve_chunk(chunk_size, n_obs, n_draws, np.dtype(dtype), None)
    assert _chunks.resolve_chunk(chunk_size, n_obs, n_draws, getattr(torch, dtype)) == want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_streaming_equals_loo_on_a_matrix(dtype):
    ll = torch_ll(torch.arange(N))
    old = tpl.rcParams["device.precision"]
    tpl.rcParams["device.precision"] = dtype
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = tpl.loo(tpl.from_dict(log_likelihood={"obs": ll.numpy().T[None]}),
                          reff=1.0, pointwise=True)
            res = tpl.loo_streaming(lambda i: ll[i], N, S, chunk_size=CHUNK, pointwise=True)
    finally:
        tpl.rcParams["device.precision"] = old
    for key in ("elpd_loo", "se", "p_loo", "p_loo_se", "looic", "looic_se"):
        assert_allclose(res[key], ref[key], **(F64 if dtype == "float64" else F32), err_msg=key)
    assert_allclose(res.loo_i.values, ref.loo_i.values.ravel(), **F64)
    assert_allclose(res.pareto_k.values, ref.pareto_k.values.ravel(), **F64)


def test_validation_errors():
    with pytest.raises(ValueError, match="at least 2 draws"):
        tpl.loo_streaming(torch_ll, N, 1)
    with pytest.raises(ValueError, match="n_obs must be positive"):
        tpl.loo_streaming(torch_ll, 0, S)
    with pytest.raises(ValueError, match="bogus"):
        tpl.loo_streaming(torch_ll, N, S, method="bogus")
    with pytest.raises(TypeError, match="Valid scale values"):
        tpl.loo_streaming(torch_ll, N, S, scale="bogus")
    with pytest.raises(ValueError, match="checkpoint_every"):
        tpl.loo_streaming(torch_ll, N, S, checkpoint_path="x.npz", checkpoint_every=0)
    with pytest.raises(TypeError, match="mesh must be a pyloo_tpu_torch.parallel.Mesh"):
        tpl.loo_streaming(torch_ll, N, S, mesh=object())

    class Source:  # a disk chunk source with fewer rows than asked for
        n_obs, n_draws = N - 1, S

        def read_rows(self, start, count):
            raise AssertionError("never read")

    with pytest.raises(ValueError, match="exceeds the 202 rows in the chunk source"):
        tpl.loo_streaming(Source(), N, S)


def test_generator_off_the_device_raises():
    # the computation device is the CPU here: a "meta" tensor stands for a
    # chunk made on another device, which is never moved silently
    with pytest.raises(ValueError, match="returned a tensor on meta"):
        tpl.loo_streaming(lambda i: torch.empty(len(i), S, device="meta"), N, S)
    with pytest.raises(TypeError, match="must return a torch.Tensor"):
        tpl.loo_streaming(lambda i: np.zeros((len(i), S)), N, S)
    with pytest.raises(ValueError, match=r"returned shape \(64, 399\)"):
        tpl.loo_streaming(lambda i: torch_ll(i)[:, 1:], N, S, chunk_size=CHUNK)
    with pytest.raises(ValueError, match="jacobian_fn returned a tensor on meta"):
        tpl.loo_streaming(torch_ll, N, S, jacobian_fn=lambda i: torch.empty(len(i), device="meta"))


class _Preempt(Exception):
    pass


def _die_at(chunk):
    def hook(c, n_chunks):
        if c == chunk:
            raise _Preempt()

    return hook


def test_checkpoint_resume_matches_a_clean_run(tmp_path):
    kw = dict(chunk_size=CHUNK // 2, pointwise=True)
    clean = tpl.loo_streaming(torch_ll, N, S, **kw)
    ckpt = str(tmp_path / "stream.ckpt.npz")
    seen = []

    def die_at_4(c, n_chunks):
        seen.append((c, n_chunks))
        _die_at(4)(c, n_chunks)

    with pytest.raises(_Preempt):
        tpl.loo_streaming(torch_ll, N, S, checkpoint_path=ckpt, checkpoint_every=2,
                          on_chunk=die_at_4, **kw)
    assert seen == [(c, 7) for c in range(1, 5)]
    assert os.path.exists(ckpt)  # saved at chunk 4 before the "preemption"
    resumed = tpl.loo_streaming(torch_ll, N, S, checkpoint_path=ckpt, checkpoint_every=2, **kw)
    _assert_same(resumed, clean, dict(rtol=1e-14, atol=1e-14))
    assert not os.path.exists(ckpt)  # removed on completion


def test_checkpoint_errors_are_the_reference_messages(tmp_path):
    ckpt = str(tmp_path / "stream.ckpt.npz")
    with pytest.raises(_Preempt):
        tpl.loo_streaming(torch_ll, N, S, chunk_size=CHUNK, checkpoint_path=ckpt,
                          checkpoint_every=1, on_chunk=_die_at(2))
    with pytest.raises(ValueError, match="was written for chunk_size=64") as port_err:
        tpl.loo_streaming(torch_ll, N, S, chunk_size=32, checkpoint_path=ckpt)

    # the reference reads the same file and refuses it in the same words
    geometry = dict(n_obs=N, n_draws=S, chunk_size=32, method="psis", dtype="float64",
                    pointwise=0, scale="log", mixture=0, jacobian=0, colgather=0)
    with pytest.raises(ValueError) as jax_err:
        jstreaming._load_checkpoint(ckpt, geometry)
    assert str(port_err.value) == str(jax_err.value)

    with np.load(ckpt) as z:
        payload = dict(z)
    payload["format_version"] = np.asarray(_checkpoint.CHECKPOINT_FORMAT_VERSION + 1)
    with open(ckpt, "wb") as fh:
        np.savez(fh, **payload)
    with pytest.raises(ValueError, match="newer than this library's 1") as port_err:
        tpl.loo_streaming(torch_ll, N, S, chunk_size=CHUNK, checkpoint_path=ckpt)
    with pytest.raises(ValueError) as jax_err:
        jstreaming._load_checkpoint(ckpt, geometry)
    assert str(port_err.value) == str(jax_err.value)


def test_clear_streaming_cache_is_a_no_op():
    assert tpl.clear_streaming_cache() is None
    assert tpl.clear_streaming_cache(torch_ll) is None


# --------------------------------------------------------------------------
# waic_streaming and loo_compare_streaming
# --------------------------------------------------------------------------

BETA2 = BETA.copy()
BETA2[:, 2:] = 0.0  # a worse model: two of the five features
_Bj2, _Bt2 = jnp.asarray(BETA2), torch.from_numpy(BETA2)


def jax_ll2(idx):
    eta = _Xj[idx] @ _Bj2.T
    return _Yj[idx, None] * eta - jnp.logaddexp(eta, 0.0)


def torch_ll2(idx):
    eta = _Xt[idx] @ _Bt2.T
    return _Yt[idx, None] * eta - torch.logaddexp(eta, torch.zeros(()))


def _recorded(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in caught]


@pytest.mark.parametrize("scale", ["log", "negative_log", "deviance"])
def test_waic_streaming_float64_matches_and_prints_alike(scale):
    jres, jmsg = _recorded(jpl.waic_streaming, jax_ll, N, S, chunk_size=CHUNK, pointwise=True,
                           scale=scale, dtype=jnp.float64)
    tres, tmsg = _recorded(tpl.waic_streaming, torch_ll, N, S, chunk_size=CHUNK, pointwise=True,
                           scale=scale, dtype="float64")
    assert tmsg == jmsg
    assert list(tres.index) == list(jres.index)
    for key in tres.index:
        t, j = tres[key], jres[key]
        if hasattr(t, "values"):
            assert t.dims == j.dims and t.name == j.name
            assert_allclose(t.values, j.values, **F64, err_msg=key)
        elif isinstance(t, (float, np.floating)):
            assert_allclose(t, j, **F64, err_msg=key)
        else:
            assert t == j, key
    assert str(tres) == str(jres)


def test_waic_streaming_against_waic_and_float32():
    ll = torch_ll(torch.arange(N)).numpy()
    stored = tpl.waic(tpl.from_dict(log_likelihood={"y": ll.T[None]}), pointwise=True)
    streamed, msgs = _recorded(tpl.waic_streaming, torch_ll, N, S, chunk_size=CHUNK,
                               pointwise=True)
    for key in ("elpd_waic", "se", "p_waic"):
        assert_allclose(streamed[key], stored[key], **F64)
    assert_allclose(streamed.waic_i.values, stored.waic_i.values, **F64)
    assert streamed["warning"] == stored["warning"]
    f32, _ = _recorded(tpl.waic_streaming, torch_ll, N, S, chunk_size=CHUNK, pointwise=True,
                       dtype="float32")
    assert f32.waic_i.values.dtype == np.float64  # float32 rows, read back as float64
    assert_allclose(f32.waic_i.values, stored.waic_i.values, **F32)
    assert_allclose(f32["elpd_waic"], stored["elpd_waic"], rtol=1e-5)


def test_waic_streaming_validation():
    with pytest.raises(ValueError, match="at least 2 draws"):
        tpl.waic_streaming(torch_ll, N, 1)
    with pytest.raises(ValueError, match="n_obs must be positive"):
        tpl.waic_streaming(torch_ll, 0, S)
    with pytest.raises(TypeError, match="mesh must be a pyloo_tpu_torch.parallel.Mesh"):
        tpl.waic_streaming(torch_ll, N, S, mesh=object())


@pytest.mark.parametrize("method", ["stacking", "bb-pseudo-bma", "pseudo-bma"])
@pytest.mark.parametrize("ic", ["loo", "waic"])
def test_loo_compare_streaming_matches(ic, method):
    from .torch_parity import assert_same_table

    kw = dict(ic=ic, method=method, seed=3, chunk_size=CHUNK)
    jres, jmsg = _recorded(jpl.loo_compare_streaming, {"a": jax_ll, "b": jax_ll2}, N, S,
                           dtype=jnp.float64, **kw)
    tres, tmsg = _recorded(tpl.loo_compare_streaming, {"a": torch_ll, "b": torch_ll2}, N, S,
                           dtype="float64", **kw)
    assert tmsg == jmsg
    assert_same_table(tres, jres, F64)


def test_loo_compare_streaming_precomputed_entries_and_hook():
    from .torch_parity import assert_same_table

    pre = tpl.loo_streaming(torch_ll2, N, S, chunk_size=CHUNK, pointwise=True)
    seen = []
    got = tpl.loo_compare_streaming({"a": torch_ll, "b": pre}, N, S, chunk_size=CHUNK,
                                    on_chunk=lambda name, c, n: seen.append((name, c, n)))
    want = tpl.loo_compare({"a": tpl.loo_streaming(torch_ll, N, S, chunk_size=CHUNK,
                                                   pointwise=True), "b": pre})
    assert seen == [("a", c, 4) for c in range(1, 5)]
    assert got.index == want.index
    for column in want.columns:
        assert got[column].tolist() == want[column].tolist(), column
    jpre = jpl.loo_streaming(jax_ll2, N, S, chunk_size=CHUNK, pointwise=True)
    jgot = jpl.loo_compare_streaming({"a": jax_ll, "b": jpre}, N, S, chunk_size=CHUNK)
    assert_same_table(got, jgot, F64)
    short = tpl.loo_streaming(torch_ll2, N - 3, S, chunk_size=CHUNK, pointwise=True)
    with pytest.raises(ValueError, match="Precomputed ELPDData for model 'b' has 200"
                                         " observations; expected 203."):
        tpl.loo_compare_streaming({"a": torch_ll, "b": short}, N, S)
    with pytest.raises(ValueError, match="ic must be 'loo' or 'waic'"):
        tpl.loo_compare_streaming({"a": torch_ll, "b": pre}, N, S, ic="kfold")
    with pytest.raises(ValueError, match="at least two models"):
        tpl.loo_compare_streaming({"a": torch_ll}, N, S)
