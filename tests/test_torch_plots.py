"""``pyloo_tpu_torch.plots`` against ``pyloo_tpu.plots`` on the CPU (Agg).

Each of the eleven plot names gets the same inputs in both packages: an
``ELPDData`` from ``loo()`` of the same arrays, and the comparison table of
``loo_compare`` (the port's ``CompareTable``, ``pyloo_tpu``'s DataFrame).
The axes must agree within rtol/atol 1e-12: every line's xy data, the
offsets of every scatter, the segments of every error bar, every patch,
texts, title, labels, tick labels, limits and legend entries.
"""

import warnings

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

import pyloo_tpu as jpl  # noqa: E402
import pyloo_tpu_torch as tpl  # noqa: E402

from .torch_parity import F64, set_precision, synthetic  # noqa: E402

torch.set_num_threads(1)

NAMES = ["plot_loo", "plot_khat", "plot_compare", "plot_influence", "plot_loo_difference",
         "plot_loo_pit", "loo_plot", "compare_plot", "influence_plot", "loo_difference_plot",
         "loo_pit_plot"]


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    set_precision("float64")
    yield
    tpl.rcParams["device.device"] = old


@pytest.fixture(autouse=True)
def close_figures():
    yield
    plt.close("all")


def _loo(pkg, idata):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pkg.loo(idata, pointwise=True)


@pytest.fixture(scope="module")
def results():
    (j1, t1), (j2, t2) = (synthetic(obs_shape=(16,), seed=s, tail=True, predictive=True)
                          for s in (0, 1))
    return {
        "j": (_loo(jpl, j1), _loo(jpl, j2), j1),
        "t": (_loo(tpl, t1), _loo(tpl, t2), t1),
    }


def axes_data(ax):
    """What an Axes draws, as plain numbers and strings."""
    out = {
        "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
        "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
        "xticks": list(ax.get_xticks()), "yticks": list(ax.get_yticks()),
        "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
        "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
        "texts": [(t.get_text(), t.get_position()) for t in ax.texts],
        "lines": [np.asarray(line.get_xydata(), float) for line in ax.lines],
        "collections": [],
        "patches": [(type(p).__name__, p.get_xy() if hasattr(p, "get_xy") else None,
                     getattr(p, "get_width", lambda: None)(),
                     getattr(p, "get_height", lambda: None)(),
                     tuple(p.get_facecolor())) for p in ax.patches],
        "legend": ([t.get_text() for t in ax.get_legend().get_texts()]
                   if ax.get_legend() is not None else None),
    }
    for coll in ax.collections:
        paths = [np.asarray(p.vertices, float) for p in coll.get_paths()]
        out["collections"].append((type(coll).__name__, np.asarray(coll.get_offsets(), float),
                                   paths, np.asarray(coll.get_facecolor(), float)))
    return out


def assert_same_axes(t_ax, j_ax):
    t, j = axes_data(t_ax), axes_data(j_ax)
    assert t.keys() == j.keys()
    for key in ("title", "xlabel", "ylabel", "xticklabels", "yticklabels", "legend"):
        assert t[key] == j[key], key
    for key in ("xlim", "ylim", "xticks", "yticks"):
        assert_allclose(t[key], j[key], err_msg=key, **F64)
    assert [s for s, _ in t["texts"]] == [s for s, _ in j["texts"]]
    for (_, tp), (_, jp) in zip(t["texts"], j["texts"]):
        assert_allclose(tp, jp, **F64)
    assert len(t["lines"]) == len(j["lines"])
    for tl, jl in zip(t["lines"], j["lines"]):
        assert_allclose(tl, jl, **F64)
    assert len(t["collections"]) == len(j["collections"])
    for (tn, to, tpaths, tc), (jn, jo, jpaths, jc) in zip(t["collections"], j["collections"]):
        assert tn == jn
        assert_allclose(to, jo, **F64)
        assert len(tpaths) == len(jpaths)
        for a, b in zip(tpaths, jpaths):
            assert_allclose(a, b, **F64)
        assert_allclose(tc, jc, **F64)
    assert len(t["patches"]) == len(j["patches"])
    for tp, jp in zip(t["patches"], j["patches"]):
        assert tp[0] == jp[0]
        for a, b in zip(tp[1:], jp[1:]):
            if b is not None:
                assert_allclose(np.asarray(a, float), np.asarray(b, float), **F64)


def _cases(name, res):
    """(args, kwargs) for one plot name, from one package's results."""
    r1, r2, idata = res
    y = idata.observed_data["y"].values
    base = name.removeprefix("plot_").removesuffix("_plot")
    if base in ("loo", "khat"):
        return [((r1,), {}), ((r1,), dict(threshold=0.5)), ((r1,), dict(show_elpd=True)),
                ((r1,), dict(threshold=0.4, textsize=9, color="C2"))]
    if base == "influence":
        return [((r1,), dict(n_points=5)), ((r1,), dict(n_points=-3, threshold=1.0)),
                ((r1,), dict(use_pareto_k=False, sort=False, n_points=None))]
    if base == "loo_difference":
        group = (np.arange(len(y)) % 3).astype(int)
        return [((y, r1, r2), {}),
                ((y, r1, r2), dict(group=group, outlier_thresh=0.3, jitter=0.1)),
                ((y, r1, r2), dict(group=group, sort_by_group=True, jitter=(0.1, 0.05)))]
    if base == "loo_pit":
        return [((), dict(data=idata)), ((), dict(data=idata, kind="hist")),
                ((), dict(data=idata, y=y, y_hat=idata.posterior_predictive["y"].values,
                          kind="hist", n_bins=7))]
    raise AssertionError(name)


@pytest.mark.parametrize("name", [n for n in NAMES if "compare" not in n])
def test_plot_draws_the_same_axes_as_pyloo_tpu(name, results):
    assert getattr(tpl, name) is getattr(tpl.plots, name)
    tcases, jcases = _cases(name, results["t"]), _cases(name, results["j"])
    for (targs, tkw), (jargs, jkw) in zip(tcases, jcases):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert_same_axes(getattr(tpl, name)(*targs, **tkw), getattr(jpl, name)(*jargs, **jkw))
        plt.close("all")


@pytest.fixture(scope="module")
def tables(results):
    def table(pkg, res, **kw):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return pkg.loo_compare({"m1": res[0], "m2": res[1], "m3": res[0]}, **kw)

    return [(table(tpl, results["t"], **kw), table(jpl, results["j"], **kw))
            for kw in ({}, dict(scale="deviance"), dict(method="bb-pseudo-bma", seed=0))]


@pytest.mark.parametrize("name", ["plot_compare", "compare_plot"])
@pytest.mark.parametrize("kw", [{}, dict(plot_ic_diff=False, title=False),
                                dict(plot_standard_error=False, legend=False, textsize=8),
                                dict(order_by_rank=False)])
def test_compare_plot_draws_the_same_axes_from_a_table_and_a_frame(name, kw, tables):
    pytest.importorskip("pandas")
    for table, frame in tables:
        j_ax = getattr(jpl, name)(frame, **kw)
        assert_same_axes(getattr(tpl, name)(table, **kw), j_ax)
        assert_same_axes(getattr(tpl, name)(table.to_pandas(), **kw), j_ax)
        plt.close("all")


def test_pointwise_tensors_are_read_on_the_host(results):
    """Tensors in an ELPDData (or passed as PIT values) plot as their numbers."""
    r1 = results["t"][0].copy()
    want = tpl.plot_loo(results["t"][0], threshold=0.5)
    r1["pareto_k"] = torch.tensor(r1["pareto_k"].values)
    r1["loo_i"] = torch.tensor(r1["loo_i"].values)
    assert_same_axes(tpl.plot_loo(r1, threshold=0.5), want)
    assert_same_axes(tpl.plot_influence(r1, n_points=4),
                     tpl.plot_influence(results["t"][0], n_points=4))
    pit = np.linspace(0.01, 0.99, 40)
    assert_same_axes(tpl.plot_loo_pit(torch.tensor(pit)), jpl.plot_loo_pit(pit))


def test_errors_match_pyloo_tpu(results):
    jr, tr = results["j"], results["t"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnp_res, tnp_res = jpl.loo(jr[2]), tpl.loo(tr[2])
    for pkg, res, bare in ((jpl, jr, jnp_res), (tpl, tr, tnp_res)):
        with pytest.raises(ValueError, match="pointwise"):
            pkg.plot_loo(bare)
        with pytest.raises(KeyError, match="not implemented"):
            pkg.plot_loo(res[0], backend="bokeh")
        with pytest.raises(ValueError, match="must match"):
            pkg.plot_loo_difference(np.zeros(3), res[0], res[1])
        with pytest.raises(ValueError, match="kind must be"):
            pkg.plot_loo_pit(np.full(5, 0.5), kind="violin")
        with pytest.raises(ValueError, match="needs `pit`"):
            pkg.plot_loo_pit()
        fig, own = plt.subplots()
        assert pkg.plot_loo(res[0], ax=own) is own


def test_backends_load_from_the_port():
    from pyloo_tpu_torch.plots import plot_utils

    for name, module in (("plot_loo", "loo_plot"), ("plot_compare", "compare_plot")):
        fn = plot_utils.get_plotting_function(name, module, "mpl")
        assert fn.__module__ == f"pyloo_tpu_torch.plots.backends.matplotlib.{module}"
