"""The benchmark's model and reference, and the port on that model, against
``pyloo_tpu``.

``benchmark/reference.py``, the plain float64 PSIS-LOO that the
benchmark's cells are checked against, is held to ``tests/oracle.py`` at
1e-12 and to ``pyloo_tpu.loo`` at 1e-8, the tolerance at which
``tests/test_psis.py`` holds ``pyloo_tpu`` to the oracle.
``benchmark/model.py``'s logistic model is the one its configurations
describe, and on it, at 2,000 observations x 400 draws on the CPU, the
port's float64 ``loo()`` on the host array and its float32
``loo_streaming`` on the generator (the calls of the host-draws and the
streaming cells) equal ``pyloo_tpu`` (float64 at 1e-12; float32 within the
float32 envelope, 1e-4).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl
from benchmark import reference
from benchmark.model import LogisticModel

from . import oracle
from .torch_parity import both

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted((REPO / "benchmark" / "configs").glob("logit32_*.json"))
SEED = 7


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    saved = (tpl.rcParams["device.device"], tpl.rcParams["device.precision"],
             jpl.rcParams["device.precision"])
    tpl.rcParams["device.device"] = "cpu"
    yield
    (tpl.rcParams["device.device"], tpl.rcParams["device.precision"],
     jpl.rcParams["device.precision"]) = saved


def _config(path: Path) -> dict:
    return json.loads(path.read_text())


def _small_model(seed: int = SEED) -> LogisticModel:
    """``logit32_s4000``'s model at 2,000 observations x 4 chains x 100 draws."""
    config = {**_config(REPO / "benchmark" / "configs" / "logit32_s4000.json"), "draws": 100}
    return LogisticModel(config, 2_000, seed, ["cpu"])


def _idata(ll, beta):
    """The arrays as a pyloo_tpu and a pyloo_tpu_torch InferenceData."""
    return both({
        "posterior": {"beta": (beta, ("chain", "draw", "beta_dim_0"), {})},
        "log_likelihood": {"y": (ll, ("chain", "draw", "obs"), {})},
    })


def test_the_float64_cell_equals_pyloo_tpu_on_its_host_array():
    model = _small_model()
    jid, tid = _idata(model.host_log_lik_f64(2_000), model.posterior()["beta"])
    tpl.rcParams["device.precision"] = jpl.rcParams["device.precision"] = "float64"
    got = tpl.loo(tid, pointwise=True)["elpd_loo"]
    assert_allclose(got, jpl.loo(jid)["elpd_loo"], rtol=1e-12)


def test_the_float32_cell_equals_pyloo_tpu_within_the_float32_envelope():
    model = _small_model()
    fn = model.log_lik_fn()
    tpl.rcParams["device.precision"] = jpl.rcParams["device.precision"] = "float32"
    got = tpl.loo_streaming(fn, 2_000, model.n_draws, reff=1.0, dtype="float32",
                            pointwise=True)["elpd_loo"]
    ll = fn(torch.arange(2_000)).numpy()  # (obs, S)
    ll = np.ascontiguousarray(ll.T.reshape(4, 100, 2_000))
    want = jpl.loo(_idata(ll, model.posterior()["beta"])[0], reff=1.0)["elpd_loo"]
    assert_allclose(got, want, rtol=1e-4)


def _rows(seed, n, s, kind):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(-1.0, 0.6, size=(n, s))
    if kind == "heavy":
        return 2.0 * rng.standard_t(2, size=(n, s)) - 1.0
    return -np.logaddexp(0.0, rng.normal(0.0, 1.0, size=(n, s)))  # logistic rows


@pytest.mark.parametrize("kind", ["normal", "heavy", "logistic"])
@pytest.mark.parametrize("s,reff", [(400, 1.0), (1000, 0.7), (4000, 1.0)])
def test_reference_equals_the_oracle(kind, s, reff):
    ll = _rows(s, 8, s, kind)
    for row in ll:
        lw, k = reference.psis_row(-row, reff)
        want_lw, want_k = oracle.psis_row(-row, reff)
        assert_allclose(lw, want_lw, rtol=1e-12, atol=1e-12)
        assert_allclose(k, want_k, rtol=1e-12, atol=1e-12)
        e, k2 = reference.loo_row(row, reff)
        want_e = oracle.logmeanexp(want_lw + row) + np.log(s)
        assert_allclose(e, want_e, rtol=1e-12, atol=1e-12)
        assert k2 == k
    assert reference.tail_length(s, reff) == int(np.ceil(min(s / 5, 3 * np.sqrt(s / reff))))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["normal", "heavy", "logistic"])
def test_reference_equals_pyloo_tpu_loo(seed, kind):
    rng = np.random.default_rng(seed)
    chains, draws, n = 4, 250, 12
    # autocorrelated chains, so that reff is not 1
    beta = rng.normal(size=(chains, draws, 3))
    beta = 0.5 * beta + 0.5 * np.roll(beta, 1, axis=1)
    ll = _rows(seed + 10, chains * draws, n, kind).reshape(chains, draws, n)
    jpl.rcParams["device.precision"] = "float64"
    res = jpl.loo(_idata(ll, beta)[0], pointwise=True)
    reff = reference.relative_eff({"beta": beta})
    e, k = reference.loo_rows(ll.reshape(chains * draws, n).T, reff)
    assert_allclose(e, res.loo_i.values, rtol=1e-8, atol=1e-8)
    assert_allclose(k, res.pareto_k.values, rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("shape", [(4, 1000, 32), (2, 301, 1), (4, 100, 3)])
def test_reference_relative_eff_equals_pyloo_tpu(shape):
    from pyloo_tpu.ops.ess import relative_eff

    rng = np.random.default_rng(shape[1])
    x = rng.normal(size=shape)
    x[1] += 0.2 * np.cumsum(rng.normal(size=shape[1:]), axis=0)  # one slow chain
    got = reference.relative_eff({"x": x})
    assert_allclose(got, relative_eff({"x": x}, shape[0] * shape[1]), rtol=1e-12)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_the_model_is_the_one_described(path):
    config = _config(path)
    f, chains, draws = config["n_features"], config["chains"], config["draws"]
    model = LogisticModel(config, 300, 3, ["cpu"])
    xw, yw, beta_s = model.copies[torch.device("cpu")]
    assert xw.shape == (300, f) and yw.shape == (300,) and beta_s.shape == (chains * draws, f)
    assert model.beta.shape == (chains, draws, f) and model.n_draws == chains * draws
    assert set(yw.unique().tolist()) <= {0.0, 1.0}
    host = model.host_log_lik_f64(120)  # (chains, draws, rows)
    made = model.log_lik_fn()(torch.arange(120)).numpy()  # (rows, S)
    assert made.dtype == np.float32
    assert_allclose(made, host.reshape(chains * draws, 120).T, rtol=1e-5, atol=1e-5)
    again = LogisticModel(config, 300, 3, ["cpu"])
    assert torch.equal(model.beta, again.beta)
    assert all(torch.equal(a, b) for a, b in zip(model.copies[torch.device("cpu")],
                                                  again.copies[torch.device("cpu")]))


_GLMM_ISOLATED = r"""
import sys
for name in ("jax", "pyloo_tpu", "pyloo_tpu_torch"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import torch
from benchmark import model_glmm, reference_mm
assert not {"jax", "pyloo_tpu", "pyloo_tpu_torch"} & {n.split(".")[0] for n in sys.modules
                                                     if sys.modules[n] is not None}
print("glmm isolated ok")
"""


def test_the_glmm_generator_and_its_reference_import_neither_the_port_nor_jax():
    """``benchmark/model_glmm.py`` (the workload's own code) and
    ``benchmark/reference_mm.py`` (the plain moment matching that decides the
    cell's ``correct``) import torch, numpy and the benchmark's plain PSIS
    only: they load with JAX, ``pyloo_tpu`` and the port blocked."""
    import re
    import subprocess
    import sys

    pattern = re.compile(r"^\s*(import|from)\s+(jax|pyloo_tpu|pyloo_tpu_torch)\b", re.MULTILINE)
    for name in ("model_glmm.py", "reference_mm.py"):
        assert not pattern.search((REPO / "benchmark" / name).read_text()), name
    script = _GLMM_ISOLATED.replace("{repo!r}", repr(str(REPO)))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "glmm isolated ok" in proc.stdout
