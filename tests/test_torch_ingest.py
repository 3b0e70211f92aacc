"""``pyloo_tpu_torch.ingest`` against ``pyloo_tpu.ingest`` on the CPU.

The same Stan CSV files (comment lines, an adaptation block, scalar, vector
and matrix columns, several chains), the same stand-in cmdstanpy fit,
foreign arviz-style object and NumPyro MCMC go through both packages: every
group, variable, dimension, coordinate and attribute is equal bit for bit,
and ``loo()`` of the result agrees within rtol/atol 1e-12 in float64.
netCDF files written by either package read back in the other.
"""

import pathlib
import types
import warnings

import numpy as np
import pytest
import torch

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl

from .test_ingest import _FakeCmdStanMCMC, _FakeMCMC, _fake_from_centered, _write_stan_csv
from .torch_parity import assert_same_rows, set_precision

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    set_precision("float64")
    yield
    tpl.rcParams["device.device"] = old


def assert_same_idata(t, j):
    """Every group, variable, dimension, coordinate and attribute equal."""
    assert t.groups() == j.groups()
    for group in j.groups():
        tg, jg = getattr(t, group), getattr(j, group)
        assert list(tg.keys()) == list(jg.keys()), group
        assert dict(tg.attrs) == dict(jg.attrs), group
        for name in jg.keys():
            tv, jv = tg[name], jg[name]
            assert tv.dims == jv.dims and tv.name == jv.name, (group, name)
            tvals, jvals = np.asarray(tv.values), np.asarray(jv.values)
            assert tvals.dtype == jvals.dtype, (group, name)
            np.testing.assert_array_equal(tvals, jvals, err_msg=f"{group}.{name}")
            assert list(tv.coords) == list(jv.coords), (group, name)
            for dim in jv.coords:
                np.testing.assert_array_equal(np.asarray(tv.coords[dim]),
                                              np.asarray(jv.coords[dim]))


def _stan_matrix_csv(path, rng, n_draws=40, save_warmup=1, n_warmup=6):
    """A CmdStan file with a (2, 3) matrix written column-major, ``%.17g``
    values, a comment between header lines and an adaptation block."""
    cols = ["lp__", "accept_stat__", "stepsize__", "treedepth__", "n_leapfrog__",
            "divergent__", "energy__", "alpha"]
    cols += [f"theta.{i}.{j}" for j in (1, 2, 3) for i in (1, 2)]
    cols += [f"log_lik.{i}" for i in range(1, 13)]

    def rows(n):
        out = []
        for _ in range(n):
            r = rng.normal(size=len(cols))
            r[7 + 6:] = -1.0 + 0.4 * r[7 + 6:]
            r[3], r[4], r[5] = 4, 15, float(rng.random() < 0.1)
            out.append(",".join(f"{v:.17g}" for v in r))
        return out

    lines = ["# model = matrix_model", "# method = sample (Default)",
             f"#   num_samples = {n_draws}", f"#   num_warmup = {n_warmup}",
             f"#   save_warmup = {save_warmup}", "", ",".join(cols)]
    if save_warmup:
        lines += rows(n_warmup)
    lines += ["# Adaptation terminated", "# Step size = 0.42",
              "# Diagonal elements of inverse mass matrix:", "# 1, 1, 1"]
    lines += rows(n_draws)
    lines += ["# ", "#  Elapsed Time: 0.02 seconds (Warm-up)"]
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def stan_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("stan")
    rng = np.random.default_rng(21)
    vec = [_write_stan_csv(str(d / f"vec_{c + 1}.csv"), rng) for c in range(3)]
    mat = [_stan_matrix_csv(str(d / f"mat_{c + 1}.csv"), rng) for c in range(2)]
    return d, vec, mat


def _both(fn_name, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return (getattr(tpl, fn_name)(*args, **kwargs),
                getattr(jpl, fn_name)(*args, **kwargs))


@pytest.mark.parametrize("which", ["vec", "mat"])
def test_from_cmdstan_equals_pyloo_tpu_and_loo_agrees(stan_dir, which):
    d, vec, mat = stan_dir
    paths = vec if which == "vec" else mat
    t, j = _both("from_cmdstan", paths)
    assert_same_idata(t, j)
    assert t.log_likelihood["log_lik"].values.shape[:2] == (len(paths), 120 if which == "vec" else 40)
    if which == "mat":
        assert t.posterior["theta"].values.shape == (2, 40, 2, 3)
    tres, jres = _both("loo", t, pointwise=True)
    assert_same_rows(tres, jres)


@pytest.mark.parametrize("kwargs", [
    dict(log_likelihood=["log_lik", "missing"]),
    dict(log_likelihood="mu", dims={"theta": ["school3"]}, coords={"school3": ["a", "b", "c"]}),
    dict(log_likelihood=None),
], ids=["list", "other_variable_with_coords", "none"])
def test_from_cmdstan_options_equal_pyloo_tpu(stan_dir, kwargs):
    _, vec, _ = stan_dir
    t, j = _both("from_cmdstan", vec, **kwargs)
    assert_same_idata(t, j)


def test_from_cmdstan_glob_and_to_inference_data(stan_dir):
    d, vec, mat = stan_dir
    pattern = str(d / "mat_*.csv")
    t, j = _both("from_cmdstan", pattern)
    assert_same_idata(t, j)
    assert_same_idata(tpl.to_inference_data(pattern), j)
    assert_same_idata(tpl.to_inference_data(pathlib.Path(vec[0])), jpl.to_inference_data(vec[0]))
    tres, jres = _both("loo", pattern, pointwise=True)
    assert_same_rows(tres, jres)


def test_from_cmdstan_errors_and_warnings_match(stan_dir, tmp_path):
    _, vec, _ = stan_dir
    other = tmp_path / "other.csv"
    other.write_text("lp__,mu\n-1.0,0.5\n")
    empty = tmp_path / "empty.csv"
    empty.write_text("# only comments\n")
    nodraws = tmp_path / "nodraws.csv"
    nodraws.write_text("lp__,mu\n")
    short = tmp_path / "short.csv"
    short.write_text("lp__,mu\n-1.0,0.5,3\n")
    ragged = tmp_path / "ragged.csv"
    ragged.write_text("lp__,a,a.1\n-1.0,0.5,3\n")
    cases = [
        (ValueError, "column names differ", ([vec[0], str(other)],)),
        (ValueError, "no header row", (str(empty),)),
        (ValueError, "no draws found", (str(nodraws),)),
        (ValueError, "data columns but", (str(short),)),
        (ValueError, "inconsistent index rank", (str(ragged),)),
        (FileNotFoundError, "no files match", (str(tmp_path / "none_*.csv"),)),
        (ValueError, "at least one CSV path", ([],)),
    ]
    for err, match, args in cases:
        for pkg in (jpl, tpl):
            with pytest.raises(err, match=match):
                pkg.from_cmdstan(*args)
    rng = np.random.default_rng(5)
    a = _write_stan_csv(str(tmp_path / "a.csv"), rng, n_draws=60)
    b = _write_stan_csv(str(tmp_path / "b.csv"), rng, n_draws=50)
    for pkg in (jpl, tpl):
        with pytest.warns(UserWarning, match="unequal draw counts"):
            pkg.from_cmdstan([a, b])
        with pytest.warns(UserWarning, match="no .*log_lik.* variable"):
            pkg.from_cmdstan(str(other))


def test_from_cmdstanpy_equals_pyloo_tpu(stan_dir):
    rng = np.random.default_rng(8)
    columns = ["lp__", "divergent__", "treedepth__", "mu", "theta.1", "theta.2",
               "log_lik.1", "log_lik.2", "log_lik.3"]
    fit = _FakeCmdStanMCMC(columns, rng.normal(size=(50, 3, len(columns))))
    t, j = _both("from_cmdstanpy", fit)
    assert_same_idata(t, j)
    bad = _FakeCmdStanMCMC(columns, np.zeros((50, 3, 2)))
    for pkg in (jpl, tpl):
        with pytest.raises(ValueError, match="expected \\(draw, chain"):
            pkg.from_cmdstanpy(bad)


def test_convert_foreign_and_to_inference_data_equal_pyloo_tpu():
    centered = jpl.load_example_data("centered_eight")
    fake = _fake_from_centered(centered)
    fake.posterior.attrs = {"inference_library": "pymc", "sampling_time": 1.5}
    t, j = _both("convert_foreign", fake)
    assert_same_idata(t, j)
    assert_same_idata(tpl.to_inference_data(fake), j)
    bare = types.SimpleNamespace(posterior=fake.posterior, log_likelihood=fake.log_likelihood)
    ingest = __import__("pyloo_tpu_torch.ingest", fromlist=["x"])
    assert ingest.looks_like_foreign_idata(bare)
    assert not ingest.looks_like_foreign_idata(t)
    assert not ingest.looks_like_foreign_idata({"mu": np.zeros((2, 5))})
    tres, jres = _both("loo", fake, pointwise=True)
    assert_same_rows(tres, jres)
    with pytest.raises(ValueError, match="no convertible"):
        tpl.convert_foreign(object())


def _fake_mcmc():
    rng = np.random.default_rng(4)
    post = {"mu": rng.normal(size=(2, 100)), "theta": rng.normal(size=(2, 100, 6))}
    extra = {
        "potential_energy": rng.normal(size=(2, 100)),
        "diverging": np.zeros((2, 100), dtype=bool),
        "num_steps": np.full((2, 100), 7),
        "accept_prob": np.full((2, 100), 0.9),
        "adapt_state.step_size": np.full((2, 100), 0.3),
        "unknown_field": np.zeros((2, 100)),
    }
    return _FakeMCMC(post, extra), rng.normal(-1.0, 0.5, size=(2, 100, 6))


def test_from_numpyro_with_log_likelihood_equals_pyloo_tpu():
    mcmc, ll = _fake_mcmc()
    kw = dict(log_likelihood={"obs": ll}, coords={"school": np.arange(6)},
              dims={"theta": ["school"], "obs": ["school"]})
    t, j = _both("from_numpyro", mcmc, **kw)
    assert_same_idata(t, j)
    assert "unknown_field" not in t.sample_stats
    np.testing.assert_array_equal(t.sample_stats["lp"].values,
                                  -mcmc._extra["potential_energy"])
    tres, jres = _both("loo", t, pointwise=True)
    assert_same_rows(tres, jres)


def test_from_numpyro_without_log_likelihood_warns_as_without_numpyro(monkeypatch):
    """The port never imports numpyro: it takes pyloo_tpu's branch for a
    missing numpyro, the same warning and no log_likelihood group."""
    import sys

    mcmc, _ = _fake_mcmc()
    monkeypatch.setitem(sys.modules, "numpyro", None)
    with pytest.warns(UserWarning, match="numpyro is not importable") as jw:
        j = jpl.from_numpyro(mcmc)
    with pytest.warns(UserWarning, match="numpyro is not importable") as tw:
        t = tpl.from_numpyro(mcmc)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert tw[0].filename == __file__
    assert "log_likelihood" not in t.groups()
    assert_same_idata(t, j)
    with pytest.raises(ValueError, match="no posterior draws"):
        tpl.from_numpyro(_FakeMCMC({}))


@pytest.mark.parametrize("writer", ["pyloo_tpu", "pyloo_tpu_torch"])
def test_netcdf_written_by_either_package_reads_in_both(writer, tmp_path):
    rng = np.random.default_rng(2)
    schools = np.array(["Choate", "Deerfield", "Phillips Andover", "Mt. Hermon"])
    groups = dict(
        posterior={"mu": rng.normal(size=(2, 30)), "theta": rng.normal(size=(2, 30, 4))},
        log_likelihood={"obs": rng.normal(-1, 0.3, size=(2, 30, 4))},
        sample_stats={"diverging": rng.random((2, 30)) < 0.1,
                      "tree_depth": rng.integers(1, 6, size=(2, 30))},
        observed_data={"obs": rng.normal(size=4)},
        coords={"school": schools, "chain": np.arange(2)},
        dims={"theta": ["school"], "obs": ["school"]},
    )
    pkg = jpl if writer == "pyloo_tpu" else tpl
    idata = pkg.from_dict(**groups)
    idata.posterior.attrs["created_by"] = writer
    idata.posterior.attrs["n_tuning"] = 500
    path = tmp_path / "x.nc"
    if writer == "pyloo_tpu":
        jpl.save_netcdf(idata, path)
    else:
        assert idata.to_netcdf(path) == str(path)
    t, j = tpl.from_netcdf(path), jpl.from_netcdf(path)
    assert_same_idata(t, j)
    assert t.posterior.attrs == {"created_by": writer, "n_tuning": 500}
    assert list(t.log_likelihood["obs"].coords["school"]) == list(schools)
    assert t.sample_stats["diverging"].values.dtype == bool
    np.testing.assert_array_equal(t.log_likelihood["obs"].values,
                                  groups["log_likelihood"]["obs"])
    assert_same_idata(tpl.to_inference_data(str(path)), j)
    tres, jres = _both("loo", str(path), pointwise=True)
    assert_same_rows(tres, jres)


def test_netcdf_files_of_both_packages_have_the_same_layout(tmp_path):
    """Same groups, datasets, dimension scales and attributes in the HDF5
    files each package writes (all but the root's ``_NCProperties``)."""
    import h5py

    centered = jpl.load_example_data("centered_eight")
    jpl.save_netcdf(centered, tmp_path / "j.nc")
    tpl.save_netcdf(jpl.from_netcdf(tmp_path / "j.nc"), tmp_path / "t.nc")

    def layout(path):
        out = {}
        with h5py.File(path, "r") as f:
            def visit(name, item):
                if isinstance(item, h5py.Dataset):
                    attrs = {k: str(v) for k, v in item.attrs.items()
                             if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}
                    out[name] = (item.shape, str(item.dtype), attrs,
                                 [d[0].name if len(d) else None for d in item.dims])
            f.visititems(visit)
        return out

    assert layout(tmp_path / "t.nc") == layout(tmp_path / "j.nc")
    with h5py.File(tmp_path / "t.nc", "r") as f:
        np.testing.assert_array_equal(f["log_likelihood/obs"][()],
                                      centered.log_likelihood["obs"].values)


def test_netcdf_errors_match(tmp_path):
    bad = tmp_path / "notnc.nc"
    bad.write_bytes(b"CDF\x01 this is netCDF3 classic, not HDF5")
    for pkg in (jpl, tpl):
        with pytest.raises(FileNotFoundError):
            pkg.from_netcdf(tmp_path / "missing.nc")
        with pytest.raises(ValueError, match="netCDF4/HDF5"):
            pkg.from_netcdf(bad)
        clash = pkg.from_dict(posterior={"a": np.zeros((2, 10, 3)), "b": np.zeros((2, 10, 4))},
                              dims={"a": ["k"], "b": ["k"]})
        with pytest.raises(ValueError, match="conflicting sizes"):
            pkg.save_netcdf(clash, tmp_path / "clash.nc")


def test_netcdf_flat_file_and_array_dimensions_fallback(tmp_path):
    import h5py

    ll = np.random.default_rng(0).normal(size=(2, 50, 5))
    with h5py.File(tmp_path / "ad.nc", "w") as f:
        d = f.create_group("log_likelihood").create_dataset("y", data=ll)
        d.attrs["_ARRAY_DIMENSIONS"] = ["chain", "draw", "y_dim_0"]
    with h5py.File(tmp_path / "flat.nc", "w") as f:
        f.create_dataset("mu", data=np.zeros((2, 10)))
    for name in ("ad.nc", "flat.nc"):
        assert_same_idata(tpl.from_netcdf(tmp_path / name), jpl.from_netcdf(tmp_path / name))
