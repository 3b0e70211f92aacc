"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy arrays
as a ``pyloo_tpu`` and a ``pyloo_tpu_torch`` InferenceData, and the
comparison of two ELPDData results row by row."""

import numpy as np
from numpy.testing import assert_allclose

import pyloo_tpu as jpl
import pyloo_tpu_torch as tpl

F64 = dict(rtol=1e-12, atol=1e-12)


def set_precision(value):
    jpl.rcParams["device.precision"] = value
    tpl.rcParams["device.precision"] = value


def groups_of(idata):
    """A pyloo_tpu InferenceData in the converter's plain-numpy form."""
    return {
        group: {
            var: (np.asarray(da.values), da.dims, dict(da.coords))
            for var, da in getattr(idata, group).items()
        }
        for group in idata.groups()
    }


def both(groups):
    """The same arrays as a pyloo_tpu and a pyloo_tpu_torch InferenceData."""
    jid = jpl.InferenceData(
        **{
            g: jpl.Dataset({v: jpl.DataArray(a, d, c, v) for v, (a, d, c) in vs.items()})
            for g, vs in groups.items()
        }
    )
    return jid, tpl.inference_data_from_numpy(groups)


def eight():
    return both(groups_of(jpl.load_example_data("centered_eight")))


def synthetic(obs_shape=(12,), chains=2, draws=300, seed=0, tail=False, predictive=False):
    """A model with ``prod(obs_shape)`` observations; with ``predictive`` also
    posterior-predictive draws and observed data."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(obs_shape))
    ll = rng.normal(-1.0, 0.6, size=(chains, draws, n))
    if tail:
        ll[:, :, :3] = 2.0 * rng.standard_t(2, size=(chains, draws, 3)) - 1.0
    obs_dims = tuple(f"obs_{i}" for i in range(len(obs_shape)))
    coords = {obs_dims[0]: np.arange(obs_shape[0]) * 10}
    groups = {
        "posterior": {
            "mu": (rng.normal(size=(chains, draws)), ("chain", "draw"), {}),
            "tau": (rng.normal(size=(chains, draws, 3)), ("chain", "draw", "tau_dim_0"), {}),
        },
        "log_likelihood": {
            "y": (ll.reshape((chains, draws) + obs_shape), ("chain", "draw") + obs_dims, coords)
        },
    }
    if predictive:
        y = rng.normal(size=obs_shape)
        groups["posterior_predictive"] = {
            "y": (
                y + rng.normal(size=(chains, draws) + obs_shape),
                ("chain", "draw") + obs_dims,
                coords,
            )
        }
        groups["observed_data"] = {"y": (y, obs_dims, coords)}
    return both(groups)


def values_of(v):
    return np.asarray(getattr(v, "values", v))


def assert_same_rows(tres, jres, tol=F64):
    """Two ELPDData results: the same rows in the same order, numbers within
    ``tol``, containers with the same dims and name."""
    assert list(tres.index) == list(jres.index)
    for key in tres.index:
        t, j = tres[key], jres[key]
        if hasattr(j, "dims"):
            assert t.dims == j.dims and t.name == j.name, key
        if isinstance(j, (str, bool, np.bool_)):
            assert t == j, key
        else:
            assert_allclose(values_of(t), values_of(j), err_msg=key, **tol)


def assert_same_table(table, frame, tol):
    """A port's CompareTable against pyloo_tpu's DataFrame, column by column,
    and its ``to_pandas()`` against the frame."""
    import pandas as pd

    assert table.index == list(frame.index)
    assert table.columns == list(frame.columns)
    for column in frame.columns:
        got, want = table[column], frame[column].to_numpy()
        if want.dtype.kind == "f":
            assert_allclose(got, want, err_msg=column, **tol)
        else:
            assert got.tolist() == want.tolist(), column
    pd.testing.assert_frame_equal(table.to_pandas(), frame, check_exact=False,
                                  rtol=tol["rtol"], atol=tol["atol"])
