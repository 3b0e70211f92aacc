"""``pyloo_tpu_torch.tools.validate_kernels`` on the CPU, at small shapes.

Each of the tool's eight sections runs with ``--device cpu`` (the kernel
wrappers return their plain versions there) on a cut of its cases, and
every case passes with ``"platform": "cpu"``.  The tool's oracle copy
equals ``tests/oracle.py`` within 1e-12; without a card the tool exits 2
unless ``--device cpu`` is given; a plain version or reference broken on
purpose makes a case fail; and the default cases cover the card's envelope
for each kernel: S below 32, B below 4, a view at an unaligned column,
every sort tier, and each input family.
"""

import json
import math

import numpy as np
import pytest
import torch

import pyloo_tpu_torch as tpl
from pyloo_tpu_torch.ops import selection, topk
from pyloo_tpu_torch.tools import oracle as tool_oracle
from pyloo_tpu_torch.tools import validate_kernels as vk

from . import oracle as test_oracle

torch.set_num_threads(1)
CPU = torch.device("cpu")
# a cut of the default cases that the CPU runs in seconds: every S and k of
# the grid up to 4,003 draws, the batches and views among them
SMALL = [c for c in vk.grid_cases(topk.MAX_K) if c[0] * c[2] <= 40_000]
SMALL_MULTI = ((40_000, 600, 2, "tpu prepass"), (33_000, 513, 1, "edge"))


@pytest.fixture(autouse=True)
def _cpu_device():
    old = tpl.rcParams["device.device"]
    tpl.rcParams["device.device"] = "cpu"
    yield
    tpl.rcParams["device.device"] = old


def _run(section):
    run = vk.Run(CPU, 20260818)
    if section in ("topk", "prepass"):
        vk.section_kernels(run, section, SMALL)
    elif section == "multi":
        vk.section_multi(run, shapes=SMALL_MULTI)
    elif section == "mm":
        vk.section_mm(run, dict(draws=100, tune=100))
    else:
        getattr(vk, f"section_{section}")(run)
    return run


@pytest.mark.parametrize("section", vk.SECTIONS)
def test_section_passes_on_the_cpu(section):
    run = _run(section)
    assert run.records, section
    failed = [r for r in run.records if not r["pass"]]
    assert failed == []
    assert {r["platform"] for r in run.records} == {"cpu"}
    assert {r["card"] for r in run.records} == {None}
    assert all(math.isfinite(r["max_abs_diff"]) for r in run.records)


def test_kernel_cases_reach_every_kernel_and_family():
    run = _run("topk")
    kernels = {r["kernel"] for r in run.records}
    assert kernels == {"B", "C", "D"}
    assert {r["family"] for r in run.records} == set(vk.FAMILIES) | {"adversarial"}
    # the overflow family overflows the candidate buffer where S allows it
    assert any(r["overflow_rows"] for r in run.records if r["kernel"] == "B")


@pytest.mark.parametrize("reff", [1.0, 0.7])
def test_oracle_copy_matches_tests_oracle(reff):
    rng = np.random.default_rng(3)
    lw = rng.normal(size=(12, 500))
    lw[:4] = rng.standard_t(2, size=(4, 500)) * 2.0
    got_lw, got_k = tool_oracle.psis_matrix(lw, reff)
    want_lw, want_k = test_oracle.psis_matrix(lw, reff)
    np.testing.assert_allclose(got_lw, want_lw, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_k, want_k, rtol=1e-12, atol=1e-12)
    y = np.sort(rng.exponential(size=200))
    np.testing.assert_allclose(tool_oracle.fit_gpd_zhang_stephens(y),
                               test_oracle.fit_gpd_zhang_stephens(y), rtol=1e-12, atol=1e-12)
    p = np.linspace(0.01, 0.99, 7)
    for k in (0.0, 0.3, -0.2):
        np.testing.assert_allclose(tool_oracle.gpd_quantile(p, k, 1.3),
                                   test_oracle.gpd_quantile(p, k, 1.3), rtol=1e-12, atol=0)


def test_no_card_exits_2_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "records.json"
    with pytest.raises(SystemExit) as exit:
        vk.main(["exact", "--out", str(out)])
    assert exit.value.code == 2 and not out.exists()
    assert vk.main(["exact", "--device", "cpu", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    assert got["platform"] == "cpu" and got["all_pass"] and got["n_cases"] == 3
    assert {case["platform"] for case in got["cases"]} == {"cpu"}
    with pytest.raises(SystemExit):
        vk.main(["nosuchsection", "--device", "cpu"])


def _broken_fold(x, k):
    return topk.topk_desc_plain(x, k).flip(1)


def _broken_radix(x, k):
    vals, refined = _REAL_RADIX(x, k)
    return vals - 1.0, refined


def _broken_prepass(x, k):
    vals, c, log_ntl, log_sum_ll = _REAL_PREPASS(x, k)
    return vals, c, log_ntl + 1e-3, log_sum_ll


def _broken_topk(x, k):
    return _REAL_TOPK(x, k)[:, :k] + 1e-3


_REAL_PREPASS = topk.loo_prepass_plain
_REAL_RADIX = topk.topk_radix_plain
_REAL_TOPK = selection.topk_vals_desc


@pytest.mark.parametrize("broken", ["fold order of D", "radix scheme", "prepass sums",
                                    "multipass merge"])
def test_a_broken_plain_version_fails_a_case(monkeypatch, broken):
    """The checks can fail: each plain version or reference broken on
    purpose makes at least one case of its section fail."""
    if broken == "fold order of D":
        monkeypatch.setattr(topk, "topk_desc_natural_fold_plain", _broken_fold)
        section, cases = "topk", [(300, 33, 5, 1, "normal")]
    elif broken == "radix scheme":
        monkeypatch.setattr(topk, "topk_radix_plain", _broken_radix)
        section, cases = "topk", [(300, 33, 5, 1, "normal")]
    elif broken == "prepass sums":
        # on the CPU the kernel wrapper is this plain version: the TPU
        # script's float64 formulas catch it
        monkeypatch.setattr(topk, "loo_prepass_plain", _broken_prepass)
        section, cases = "prepass", [(300, 33, 5, 1, "normal")]
    else:
        monkeypatch.setattr(selection, "topk_vals_desc", _broken_topk)
        section, cases = "multi", None
    run = vk.Run(CPU, 1)
    if section == "multi":
        vk.section_multi(run, shapes=(), narrow=((127, 31, 4),))
    else:
        vk.section_kernels(run, section, cases)
    assert any(not r["pass"] for r in run.records), run.records


@pytest.mark.parametrize("max_k", [topk.MAX_K, topk.BITONIC_MAX_K])
def test_default_cases_cover_the_cards_envelope(max_k):
    """For kernels A and B (k <= 1,024) and C and D (k <= 256): every S of
    the card's edges, every k tier and its neighbours, every batch, every
    view column and family; S below 32, B below 4 and unaligned views; each
    sort tier P; rows that overflow the candidate buffer (S above
    candidate_cap(k))."""
    cases = vk.grid_cases(max_k)
    s_, k_, b_, col_, fam_ = (set(v) for v in zip(*cases))
    assert set(vk.S_EDGES) <= s_
    assert {k for k in vk.K_TIERS if k <= max_k} <= k_
    assert set(vk.BATCHES) <= b_ and set(vk.VIEW_COLS) <= col_ and set(vk.FAMILIES) <= fam_
    assert any(s < 32 for s in s_) and any(b < 4 for b in b_)
    tiers = {32 << i for i in range(6) if 32 << i <= max(max_k, 32)}
    assert {max(32, 1 << (k - 1).bit_length()) for k in k_} == tiers
    for family in vk.FAMILIES:
        assert any(c[4] == family and c[2] < 4 for c in cases)
        assert any(c[4] == family and c[3] > 0 for c in cases)
    assert any(c[4] == "overflow" and c[0] > topk.candidate_cap(c[1]) for c in cases)
    assert any(c[4] == "overflow" and c[1] > 256 and c[0] > topk.candidate_cap(c[1])
               for c in cases) == (max_k > 256)


def test_families_make_what_they_name():
    gen = torch.Generator().manual_seed(0)
    k = 33
    s = topk.candidate_cap(k) + 100
    over = vk.overflow_rows(6, s, k, gen, CPU)
    assert bool(topk.topk_radix_plain(over, k)[1].all())  # every row narrows further
    ties = vk.ties_rows(3, 400, k, gen, CPU)
    kth = torch.topk(ties, k, dim=1).values[:, k - 1]
    assert bool(((ties == kth[:, None]).sum(1) > 1).all())  # ties at the k-th place
    x, names = vk.edge_rows(40, 7, 5, gen, CPU)
    assert len(names) == 26 and bool(x[:2].isnan().any(1).all())
    view = vk.as_view(torch.ones(3, 10), 3)
    assert view.stride(0) == 10 + vk.VIEW_PAD and view.storage_offset() == 3
    assert bool(view.eq(1).all()) and bool(view.untyped_storage().nbytes() == 4 * 3 * 17)


def test_psislw_takes_a_tensor_as_a_tensor():
    """The fault the exact section found on the card: ``psislw`` of a tensor
    on the card raised, because ``as_sample_matrix`` read every array through
    numpy, which cannot read a tensor there.  A tensor now goes to the
    device as a tensor; here one that numpy refuses too (it requires grad)
    gives what its numpy values give."""
    rng = np.random.default_rng(5)
    lw = rng.normal(size=(6, 300))
    want_lw, want_k = tpl.psislw(lw)
    tensor = torch.tensor(lw, requires_grad=True)
    with pytest.raises(RuntimeError):
        np.asarray(tensor)
    got_lw, got_k = tpl.psislw(tensor)
    np.testing.assert_array_equal(got_lw, want_lw)
    np.testing.assert_array_equal(got_k, want_k)
    got_lw, got_k = tpl.psislw(torch.tensor(lw[0]))
    assert got_lw.shape == (300,) and np.ndim(got_k) == 0


def test_phase_16_finds_the_default_cases_cover_the_envelope():
    """``chip_smoke.tool_coverage`` (phase 16's check on the card's records)
    finds nothing missing in the default cases' records, and names what a
    cut of them lacks."""
    import chip_smoke

    records = [{"kernel": letter, "s": s, "k": k, "b": b, "col": col, "family": family}
               for letter, max_k in (("A", 1_024), ("B", 1_024), ("C", 256), ("D", 256))
               for s, k, b, col, family in vk.grid_cases(max_k)]
    assert chip_smoke.tool_coverage(records) == []
    cut = [r for r in records if r["k"] <= 512 and r["family"] != "edge"]
    missing = chip_smoke.tool_coverage(cut)
    assert "A: every sort tier" in missing and "D: edge" in missing


def test_weighted_quantile_takes_probabilities_as_a_tensor():
    """The fault the eloo section found on the card: ``weighted_quantile_batch``
    read ``probs`` through numpy, which cannot read a tensor there (the
    TPU script passes ``jnp`` probabilities).  A tensor, here one numpy
    refuses too, gives what its values give."""
    from pyloo_tpu_torch.ops.expectations import weighted_quantile_batch

    rng = np.random.default_rng(2)
    x, lw = (torch.as_tensor(rng.normal(size=(4, 200))) for _ in range(2))
    probs = [0.1, 0.5, 0.9]
    want = weighted_quantile_batch(x, lw, probs)
    got = weighted_quantile_batch(x, lw, torch.tensor(probs, dtype=torch.float64,
                                                      requires_grad=True))
    assert torch.equal(got, want)


def test_sections_run_in_float64_whatever_the_caller_left(monkeypatch):
    """As in the fuzz: the float64 sections hold at their tolerances after a
    caller left ``rcParams["device.precision"]`` at float32."""
    monkeypatch.setitem(tpl.rcParams, "device.precision", "float32")
    run = vk.Run(CPU, 20260818)
    assert vk.run_sections(run, ["exact", "eloo"])
    assert tpl.rcParams["device.precision"] == "float32"
