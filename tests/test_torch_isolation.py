"""pyloo_tpu_torch runs where neither JAX nor pandas exists.

The machine with the card has no JAX and no pandas, so the package must
import and run ``loo`` with both blocked, and must never import
``pyloo_tpu``; nor may the benchmark, ``bench_torch/``.  A device of
``"cuda"`` without a CUDA device raises instead of computing on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["pandas"] = None
sys.path.insert(0, {repo!r})
import torch
import pyloo_tpu_torch as pl
import pyloo_tpu_torch.streaming
import pyloo_tpu_torch.ops.topk_profile
import importlib
for name in ("base", "psis", "sis", "tis", "waic", "loo_i", "e_loo", "loo_predictive_metric",
             "diagnostics", "generic_elpd", "loo_group", "ops.expectations", "ops.selection",
             "compare", "loo_score", "loo_lfo", "ops.stacking", "streaming.waic",
             "streaming.score", "streaming.compare", "_native", "io", "constants",
             "estimators", "approximations", "loo_approximate_posterior", "loo_subsample",
             "streaming.expectations", "streaming.group", "streaming.subsample",
             "models", "models.wrapper", "models.hmc", "models.examples",
             "models.batched_refit", "helpers", "ops.moment_match", "split_moment_match",
             "loo_moment_match", "loo_kfold", "reloo", "models.nuts", "models.chees",
             "models.advi", "models.laplace", "ops.nonfactor", "loo_nonfactor",
             "streaming.nonfactor",
             "parallel", "parallel.sharding", "parallel.witness", "ops.guard",
             "tools.validate_kernels", "tools.fuzz_differential", "tools.oracle"):
    importlib.import_module("pyloo_tpu_torch." + name)

# the bundled data lie inside the package
import pathlib
from pyloo_tpu_torch.data import _DATA_DIR
package = pathlib.Path(pl.__file__).resolve().parent
assert package in pathlib.Path(_DATA_DIR).resolve().parents, _DATA_DIR

pl.rcParams["device.device"] = "cpu"
res = pl.loo(pl.load_example_data("centered_eight"))
assert round(res["elpd_loo"], 4) == -30.7807, res["elpd_loo"]
ll = torch.randn(40, 100, dtype=torch.float64)
res = pl.loo_streaming(lambda idx: ll[idx], 40, 100, chunk_size=16)
assert res["n_data_points"] == 40

# the weights path: psislw -> e_loo, and each of the other entry points
import numpy as np
eight = pl.load_example_data("centered_eight")
log_lik = eight.log_likelihood.obs.stack(__sample__=("chain", "draw"))
rng = np.random.default_rng(0)
y = rng.normal(size=6)
pred = pl.from_dict(
    posterior={"b": rng.normal(size=(2, 100))},
    log_likelihood={"y": rng.normal(-1.0, 0.3, size=(2, 100, 6))},
    posterior_predictive={"y": y + rng.normal(size=(2, 100, 6))},
    observed_data={"y": y},
)
weights_path = {
    "psislw": lambda: pl.psislw(-log_lik),
    "psislw_compact": lambda: pl.psislw_compact(-log_lik),
    "sislw": lambda: pl.sislw(-log_lik),
    "tislw": lambda: pl.tislw(-log_lik),
    "compute_importance_weights": lambda: pl.compute_importance_weights(-log_lik),
    "waic": lambda: pl.waic(eight),
    "loo_i": lambda: pl.loo_i(2, eight),
    "elpd": lambda: pl.elpd(eight),
    "loo_group": lambda: pl.loo_group(eight, np.arange(8) // 2),
    "mcse_loo": lambda: pl.mcse_loo(eight),
    "psis_ess_values": lambda: pl.psis_ess_values(eight),
    "loo_pit": lambda: pl.loo_pit(pred),
    "loo_predictive_metric": lambda: pl.loo_predictive_metric(pred, y),
    "compute_pareto_k": lambda: pl.compute_pareto_k(None, np.zeros((2, 50))),
    "k_hat": lambda: pl.k_hat(None, np.arange(50.0)),
}
lw, k = pl.psislw(-log_lik)
weights_path["e_loo"] = lambda: pl.e_loo(eight, group="posterior", var_name="theta", log_weights=lw)
weights_path["CompactWeights.weighted_mean"] = lambda: compact.weighted_mean(
    log_lik.values, -log_lik.values)
compact = pl.psislw_compact(-log_lik)
# scoring and comparison, and the streaming forms
ll_rows = torch.from_numpy(np.ascontiguousarray(log_lik.values))  # (8, S)
pred_rows = torch.from_numpy(rng.normal(size=(6, 200)))
series = pl.from_dict(posterior={"b": rng.normal(size=(2, 100))},
                      log_likelihood={"y": rng.normal(-1.0, 0.3, size=(2, 100, 30))})
gen = lambda idx: ll_rows[idx]  # noqa: E731
pgen = lambda idx: pred_rows[idx]  # noqa: E731
from pyloo_tpu_torch.ops.stacking import stacking_weights_em
weights_path.update({
    "loo_compare": lambda: pl.loo_compare({"a": eight, "b": eight}),
    "compare": lambda: pl.compare({"a": eight, "b": eight}, method="pseudo-bma"),
    "loo_model_weights": lambda: pl.loo_model_weights({"a": eight, "b": eight}),
    "loo_score": lambda: pl.loo_score(pred, permutations=2, seed=0),
    "loo_lfo": lambda: pl.loo_lfo(series, L=10, M=2),
    "waic_streaming": lambda: pl.waic_streaming(gen, 8, 2000),
    "loo_score_streaming": lambda: pl.loo_score_streaming(pgen, pgen, pgen, y, 6, 200),
    "loo_compare_streaming": lambda: pl.loo_compare_streaming({"a": gen, "b": gen}, 8, 2000),
    "stacking_weights_em": lambda: stacking_weights_em(np.zeros((5, 2))),
})
# disk chunk sources, the streaming readers, subsampling, approximate posteriors
import tempfile
npy = tempfile.NamedTemporaryFile(suffix=".npy", delete=False).name
np.save(npy, np.ascontiguousarray(log_lik.values))
eight_ll = eight.log_likelihood.obs.values
log_p, log_q = rng.normal(size=(2, 2000))
weights_path.update({
    "loo_from_file": lambda: pl.loo_from_file(npy, native=True, chunk_size=8),
    "waic_from_file": lambda: pl.waic_from_file(npy, native=False),
    "e_loo_streaming": lambda: pl.e_loo_streaming(gen, gen, 8, 2000, type="sd"),
    "loo_predictive_metric_streaming": lambda: pl.loo_predictive_metric_streaming(
        gen, gen, np.zeros(8), 8, 2000),
    "loo_group_streaming": lambda: pl.loo_group_streaming(gen, np.arange(8) % 3, 8, 2000),
    "loo_subsample": lambda: pl.loo_subsample(eight, observations=4, seed=0),
    "update_subsample": lambda: pl.update_subsample(
        pl.loo_subsample(eight, observations=4, seed=0), observations=6),
    "loo_subsample_streaming": lambda: pl.loo_subsample_streaming(gen, 8, 2000, 4, seed=0),
    "importance_resample": lambda: pl.importance_resample(log_p, log_q, seed=0),
    "loo_approximate_posterior": lambda: pl.loo_approximate_posterior(
        eight, log_p, log_q, seed=0),
    "loo_approximate_posterior_streaming": lambda: pl.loo_approximate_posterior_streaming(
        gen, log_p, log_q, 8, 2000, seed=0),
    "loo_compare(observations=)": lambda: pl.loo_compare({"a": eight, "b": eight},
                                                         observations=4),
})
for call in weights_path.values():
    call()
assert pl.crps(np.ones((10, 3)), np.zeros((10, 3)), np.ones(3)).pointwise.shape == (3,)
assert pl.scrps(np.ones((10, 3)), np.zeros((10, 3)), np.ones(3)).pointwise.shape == (3,)
table = pl.loo_compare({"a": eight, "b": eight})
assert table.index == ["a", "b"] and abs(table["weight"].sum() - 1.0) < 1e-9
for frame in (table, pl.loo_model_weights({"a": eight, "b": eight})):
    try:
        frame.to_pandas()
    except ImportError:
        pass
    else:
        raise AssertionError("to_pandas() found pandas although it is blocked")
means = pl.e_loo(eight, group="posterior", var_name="theta", log_weights=lw, log_ratios=-log_lik)
assert means.value.shape == (8,) and float(k.values.max()) < 0.7
assert round(pl.waic(eight)["elpd_waic"], 4) == -30.7378, pl.waic(eight)["elpd_waic"]
with pl.NpyLogLik(npy) as src:
    assert src.is_native and src.n_obs == 8
    assert abs(pl.loo_streaming(src, 8, 2000)["elpd_loo"] - pl.loo(eight, reff=1.0)["elpd_loo"]) < 1e-9
assert "subsampled" in str(pl.loo_subsample(eight, observations=4, seed=0))
# the model wrappers: a fit, moment matching and refits
roaches = pl.models.roaches_model()
fit_kw = dict(draws=20, tune=20, chains=2, num_leapfrog=2, seed=0)
roach_fit = pl.models.fit(roaches, **fit_kw)
assert pl.load_example_data("wells")["switch"].shape == (3020,)
roach_w = pl.JAXModelWrapper(roaches, roach_fit, sample_kwargs=fit_kw)
roach_loo = pl.loo(roach_fit, pointwise=True)
mm = pl.loo(roach_fit, pointwise=True, moment_match=True, wrapper=roach_w, max_iters=2)
assert np.isfinite(mm["elpd_loo"])
refits = {
    "fit": lambda: pl.models.fit(roaches, **fit_kw),
    "loo_moment_match": lambda: pl.loo_moment_match(roach_w, roach_loo, max_iters=1),
    "loo_kfold": lambda: pl.loo_kfold(roach_w, K=2, random_seed=0),
    "reloo": lambda: pl.reloo(roach_w, loo_orig=roach_loo, k_thresh=10.0),
    "kfold_refit_batched": lambda: __import__(
        "pyloo_tpu_torch.models.batched_refit", fromlist=["x"]).kfold_refit_batched(
        roaches, np.arange(10).reshape(2, 5), np.arange(10, 12).reshape(2, 1), **fit_kw),
}
assert pl.loo_kfold(roach_w, K=2, random_seed=0)["K"] == 2
weights_path.update(refits)
# the samplers, the variational fits and non-factorised LOO
eight_nc = pl.models.eight_schools_noncentered()
small = dict(draws=4, tune=4, chains=2, seed=0)
cov = np.broadcast_to(np.eye(6), (2, 50, 6, 6))
mvn = pl.from_dict(posterior={"mu": rng.normal(0, 0.1, size=(2, 50, 6)), "cov": cov,
                              "df": np.full((2, 50), 5.0)}, observed_data={"y": y})
fits = {
    "fit(nuts)": lambda: pl.models.fit(eight_nc, algorithm="nuts", max_depth=3, **small),
    "fit(chees)": lambda: pl.models.fit(eight_nc, algorithm="chees", max_leapfrog=4, **small),
    "ADVI": lambda: pl.ADVI(eight_nc, "fullrank").fit(n=5, draws=10),
    "Laplace": lambda: pl.Laplace(eight_nc).fit(draws=10, chains=1),
    "loo_nonfactor": lambda: pl.loo_nonfactor(mvn, reff=1.0),
    "loo_nonfactor(student_t)": lambda: pl.loo_nonfactor(mvn, reff=1.0, model_type="student_t"),
    "loo_nonfactor_streaming": lambda: pl.loo_nonfactor_streaming(
        y, 0.0, lambda idx: torch.eye(6, dtype=torch.float64).expand(len(idx), 6, 6), 100,
        chains=2),
}
import warnings
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    for call in fits.values():
        call()
    assert "multivariate normal" in str(pl.loo_nonfactor(mvn, reff=1.0))
weights_path.update(fits)
loaded = [m for m, mod in sys.modules.items() if mod is not None]
assert not any(m == "pyloo_tpu" or m.startswith(("pyloo_tpu.", "jax", "pandas")) for m in loaded)

if not torch.cuda.is_available():
    pl.rcParams["device.device"] = "cuda"
    weights_path["loo"] = lambda: pl.loo(eight)
    for name, call in weights_path.items():
        try:
            call()
        except RuntimeError as err:
            # loo_compare names the model and chains the device's error as its cause
            assert "no CUDA device" in str(err) + str(err.__cause__), (name, err)
        else:
            raise AssertionError(name + " fell back to the CPU")
import os
os.remove(npy)
print("isolated ok")
"""


def test_runs_without_jax_or_pandas_and_never_falls_back(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT.replace("{repo!r}", repr(str(REPO)))],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
        cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    assert "isolated ok" in proc.stdout


def test_no_source_imports_jax_or_pyloo_tpu():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|pyloo_tpu)\b", re.MULTILINE)
    offenders = [
        str(path.relative_to(REPO))
        for path in (REPO / "pyloo_tpu_torch").rglob("*.py")
        if pattern.search(path.read_text())
    ]
    assert offenders == []


def test_bench_torch_imports_neither_jax_pandas_nor_pyloo_tpu():
    """The benchmark's files import torch, numpy and the port only: no
    JAX, pandas or pyloo_tpu, and nothing of chip_smoke.py or the tests."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|pandas|pyloo_tpu|chip_smoke|tests)\b",
                         re.MULTILINE)
    files = sorted((REPO / "bench_torch").rglob("*.py"))
    assert len(files) == 5
    assert [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())] == []


def test_verification_tools_import_neither_jax_pandas_nor_pyloo_tpu():
    """The two verification tools (and what they share) import torch, numpy,
    scipy and the port only: no JAX, pandas or pyloo_tpu, and nothing of
    chip_smoke.py, bench_torch/ or the tests."""
    import re

    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|pandas|pyloo_tpu|chip_smoke|bench_torch|tests)\b",
        re.MULTILINE)
    files = [REPO / "pyloo_tpu_torch" / "tools" / name
             for name in ("validate_kernels.py", "fuzz_differential.py", "oracle.py",
                          "_harness.py")]
    assert [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())] == []


_TOOLS = r"""
import sys
for name in ("jax", "pandas", "pyloo_tpu", "chip_smoke", "bench_torch", "tests"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import torch
from pyloo_tpu_torch.tools import fuzz_differential, validate_kernels
assert validate_kernels.main(["exact", "--device", "cpu", "--out", "records.json"]) == 0
assert fuzz_differential.main(["1", "7", "subsample", "--device", "cpu"]) == 0
if not torch.cuda.is_available():
    for main, argv in ((validate_kernels.main, ["exact"]), (fuzz_differential.main, ["1"])):
        try:
            main(argv)
        except SystemExit as exit:
            assert exit.code == 2, exit.code
        else:
            raise AssertionError("a tool ran on the CPU without --device cpu")
print("tools isolated ok")
"""


def test_verification_tools_run_with_jax_pandas_and_pyloo_tpu_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _TOOLS.replace("{repo!r}", repr(str(REPO)))],
                          capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert "tools isolated ok" in proc.stdout


_BENCH = r"""
import runpy
import sys
for name in ("jax", "pandas", "pyloo_tpu", "chip_smoke", "tests"):
    sys.modules[name] = None
for cell in ("loo_streaming_logit32_1m_x_4k_f32", "loo_logit32_262k_x_4k_f64_host"):
    sys.argv = ["bench.py", "--cell", cell, "--device", "cpu", "--n-obs", "600",
                "--draws", "50"]
    try:
        runpy.run_path({path!r}, run_name="__main__")
    except SystemExit as exit:
        assert exit.code == 0, exit.code
print("bench isolated ok")
"""


def test_bench_torch_runs_with_jax_pandas_and_pyloo_tpu_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    script = _BENCH.replace("{path!r}", repr(str(REPO / "bench_torch" / "bench.py")))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("gate passed") == 2 and "bench isolated ok" in proc.stdout


def test_chip_smoke_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script runs in full there")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


_SLICE10 = r"""
import sys
for name in ("jax", "pandas", "numpyro", "h5py", "matplotlib", "pyloo_tpu", "pymc", "pytensor"):
    sys.modules[name] = None
sys.path.insert(0, {repo!r})
import importlib
import pathlib
import tempfile
import types
import warnings
import numpy as np
import torch
import pyloo_tpu_torch as pl
for name in ("ingest", "warmup", "profiling", "plots", "plots.plot_utils", "plots.loo_plot",
             "plots.compare_plot", "plots.influence_plot", "plots.loo_difference_plot",
             "plots.loo_pit_plot", "plots.backends", "models.pymc_adapter", "wrapper",
             "wrapper.pymc"):
    importlib.import_module("pyloo_tpu_torch." + name)
pl.rcParams["device.device"] = "cpu"
tmp = pathlib.Path(tempfile.mkdtemp())
csv = tmp / "out_1.csv"
rows = np.random.default_rng(0).normal(-1.0, 0.3, size=(50, 5))
csv.write_text("# num_samples = 50\nlp__,mu,log_lik.1,log_lik.2,log_lik.3\n"
               + "\n".join(",".join(f"{v:.17g}" for v in r) for r in rows) + "\n")
idata = pl.to_inference_data(str(tmp / "out_*.csv"))
assert idata.log_likelihood["log_lik"].shape == (1, 50, 3)
with warnings.catch_warnings():
    warnings.simplefilter("ignore")
    assert np.isfinite(pl.loo(idata)["elpd_loo"])
mcmc = types.SimpleNamespace(get_samples=lambda group_by_chain: {"mu": rows[:, :2].T})
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    assert "log_likelihood" not in pl.from_numpyro(mcmc).groups()
assert "numpyro is not importable" in str(caught[0].message)
class ForeignDataset(dict):  # the xarray protocol: data_vars, [name].dims / .values
    data_vars = property(lambda self: dict(self))
foreign = types.SimpleNamespace(log_likelihood=ForeignDataset(
    y=types.SimpleNamespace(dims=("chain", "draw", "y_dim_0"), values=rows.reshape(2, 25, 5))))
assert pl.to_inference_data(foreign).log_likelihood["y"].shape == (2, 25, 5)
for call in (lambda: pl.from_netcdf(csv), lambda: pl.save_netcdf(idata, tmp / "x.nc"),
             lambda: pl.plot_loo(pl.loo(idata, pointwise=True))):
    try:
        call()
    except ImportError:
        pass
    else:
        raise AssertionError("an optional dependency was found although it is blocked")
res = pl.warmup(64, 20, chunk_size=32, dtype="float64")
assert res["chunk_size"] == 32 and res["compilation_cache"] is False
# the multi-device layer over a mesh of CPU shards, and the witness's census
from pyloo_tpu_torch.parallel import Mesh, witness
mesh_ll = torch.randn(300, 40, dtype=torch.float64) - 1.0
meshed = pl.loo_streaming(lambda idx: mesh_ll[idx], 300, 40, chunk_size=256,
                          mesh=Mesh(["cpu"] * 4), pointwise=True)
alone = pl.loo_streaming(lambda idx: mesh_ll[idx], 300, 40, chunk_size=256, pointwise=True)
assert (meshed.loo_i.values == alone.loo_i.values).all()
witness.assert_scalar_only_transfers(witness.census_of(
    [{"name": "Memcpy PtoP (Device -> Device)", "args": {"bytes": 8}}]))
from pyloo_tpu_torch import profiling
with profiling.trace(str(tmp / "trace")):
    with profiling.annotate("region"):
        pl.loo_streaming(lambda idx: torch.zeros(len(idx), 20, dtype=torch.float64) - idx[:, None] * 1e-3
                         - torch.arange(20.0, dtype=torch.float64) * 1e-4, 64, 20)
assert sorted(p.name.split("_")[0] for p in (tmp / "trace").iterdir()) == ["counters", "trace"]
from pyloo_tpu_torch.models import pymc_adapter
try:
    pl.PyMCWrapper(type("M", (), {"__module__": "pymc.model", "basic_RVs": (), "value_vars": ()})())
except ImportError as err:
    assert "requires pymc" in str(err)
else:
    raise AssertionError("from_pymc ran without pymc")
y = np.arange(5.0)
bridge = pymc_adapter.PyTensorJaxBridge(
    name="b", param_shapes={"mu": ()},
    logp=lambda p: -0.5 * p["mu"] ** 2 + torch.sum(-0.5 * (torch.as_tensor(y) - p["mu"]) ** 2),
    log_lik=lambda p: -0.5 * (torch.as_tensor(y) - p["mu"]) ** 2,
    observed={"y": y}, forward=lambda c: {"mu": c["mu"]})
wrapper = pl.PyMCWrapper(pymc_adapter.from_bridge(bridge))
assert wrapper.n_obs == 5
flat = pymc_adapter.unconstrain_posterior(bridge, {"mu": np.zeros((2, 3))})
assert flat.shape == (2, 3, 1)
loaded = [m for m, mod in sys.modules.items() if mod is not None]
banned = ("jax", "pandas", "numpyro", "h5py", "matplotlib", "pyloo_tpu.", "pymc", "pytensor")
assert not any(m == "pyloo_tpu" or m.startswith(banned) for m in loaded), [
    m for m in loaded if m.startswith(banned)]
if not torch.cuda.is_available():
    pl.rcParams["device.device"] = "cuda"
    for name, call in {
        "warmup": lambda: pl.warmup(64, 20),
        "trace": lambda: profiling.trace(str(tmp)).__enter__(),
        "unconstrain_posterior": lambda: pymc_adapter.unconstrain_posterior(
            bridge, {"mu": np.zeros((2, 3))}),
        "loo(cmdstan)": lambda: pl.loo(str(csv)),
    }.items():
        try:
            call()
        except RuntimeError as err:
            assert "no CUDA device" in str(err), (name, err)
        else:
            raise AssertionError(name + " fell back to the CPU")
print("slice 10 isolated ok")
"""


def test_ingestion_plots_warmup_and_bridge_run_with_optional_packages_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _SLICE10.replace("{repo!r}", repr(str(REPO)))],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
        cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stderr
    assert "slice 10 isolated ok" in proc.stdout


def test_every_public_name_of_pyloo_tpu_is_in_the_port():
    import pyloo_tpu
    import pyloo_tpu_torch

    assert set(pyloo_tpu.__all__) <= set(pyloo_tpu_torch.__all__)
    assert len(set(pyloo_tpu_torch.__all__)) == len(pyloo_tpu_torch.__all__)
    assert all(hasattr(pyloo_tpu_torch, name) for name in pyloo_tpu_torch.__all__)


def test_no_module_imports_pandas_numpyro_or_an_optional_package_at_load():
    """pandas and numpyro are never imported at module level (``to_pandas``
    imports pandas when called), nor h5py; matplotlib only in the plot
    backends, which load when a plot is drawn.  chip_smoke.py imports none of
    them, nor JAX or pyloo_tpu."""
    import re

    top = re.compile(r"^(import|from)\s+(pandas|numpyro|h5py|matplotlib|pymc|pytensor)\b",
                     re.MULTILINE)
    backends = REPO / "pyloo_tpu_torch" / "plots" / "backends"
    offenders = [
        str(path.relative_to(REPO))
        for path in (REPO / "pyloo_tpu_torch").rglob("*.py")
        if top.search(path.read_text()) and backends not in path.parents
    ]
    assert offenders == []
    anywhere = re.compile(r"^\s*(import|from)\s+(jax|pandas|numpyro|pyloo_tpu)\b", re.MULTILINE)
    assert not anywhere.search((REPO / "chip_smoke.py").read_text())


# Public names of pyloo_tpu's modules that the port leaves out, by module
# ("*": every name of the module), each with its reason.
NOT_PORTED = {
    "ops.pallas_topk": {
        "*": "the Pallas TPU kernels and their (8, 128) tile layout, tile_rows among them;"
             " the CUDA kernels that replace them are ops.topk's",
    },
    "ops.loo_kernels": {
        "loo_scores_psis_fast_tiled": "the float32 scorer over the TPU tile layout of"
                                      " pallas_topk.tile_rows",
    },
    "ops.selection": {
        "topk_hybrid_f64": "a float32-proxy selection for the TPU's emulated float64, rejected"
                           " in pyloo_tpu itself (ops/loo_kernels.py:281)",
    },
    "parallel": {
        "obs_sharding": "a jax.sharding.NamedSharding: the port's Mesh deals the rows itself",
        "replicated_sharding": "a jax.sharding.NamedSharding: the port's Mesh deals the rows"
                               " itself",
    },
    "parallel.sharding": {
        "obs_sharding": "a jax.sharding.NamedSharding: the port's Mesh deals the rows itself",
        "replicated_sharding": "a jax.sharding.NamedSharding: the port's Mesh deals the rows"
                               " itself",
    },
    "parallel.witness": {
        "collective_census": "reads the collectives of a compiled SPMD program; the port's"
                             " transfer_census reads the copies a run made",
        "assert_scalar_only_collectives": "over collective_census; the port's is"
                                          " assert_scalar_only_transfers",
        "compiled_flops": "XLA's FLOP count of a compiled program; an eager call has none"
                          " (see the witness module's docstring)",
    },
}


def _pyloo_tpu_modules():
    """``(suffix, module)`` of every source module of pyloo_tpu with an ``__all__``."""
    import importlib
    import importlib.util
    import pkgutil

    import pyloo_tpu

    for info in pkgutil.walk_packages(pyloo_tpu.__path__, "pyloo_tpu."):
        if not importlib.util.find_spec(info.name).origin.endswith(".py"):
            continue  # a built extension, not a module of the package's source
        module = importlib.import_module(info.name)
        if hasattr(module, "__all__"):
            yield info.name[len("pyloo_tpu."):], module


def test_every_module_of_pyloo_tpu_has_its_public_names_in_the_port():
    import importlib

    missing, excluded_but_present = [], []
    for suffix, module in _pyloo_tpu_modules():
        left_out = NOT_PORTED.get(suffix, {})
        if "*" in left_out:
            try:
                importlib.import_module("pyloo_tpu_torch." + suffix)
            except ModuleNotFoundError:
                continue
            excluded_but_present.append(suffix)
            continue
        port = importlib.import_module("pyloo_tpu_torch." + suffix)
        exported = set(getattr(port, "__all__", ()))
        for name in module.__all__:
            here = name in exported and hasattr(port, name)
            if name in left_out:
                if here:
                    excluded_but_present.append(f"{suffix}.{name}")
            elif not here:
                missing.append(f"{suffix}.{name}")
    assert missing == []
    assert excluded_but_present == []  # the list names exactly what is left out
    seen = dict(_pyloo_tpu_modules())
    for suffix, names in NOT_PORTED.items():
        assert suffix in seen
        assert all(name == "*" or name in seen[suffix].__all__ for name in names)
