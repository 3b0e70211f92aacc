"""Top-k kernels C ("reshape") and D ("natural") against pyloo_tpu on the CPU.

On the CPU ``topk_desc(x, k, variant=...)`` runs the variant's plain version,
which follows the kernel's merge scheme in tensor ops.  These tests hold it
to the Pallas kernel itself (``pallas_topk_desc(..., interpret=True)``) and
to ``torch.topk``; both must agree exactly (``torch.equal``).  The CUDA
kernels are compared with these plain versions and with ``torch.topk`` on
the card by ``chip_smoke.py``.

The Pallas kernel is run once per (variant, S) at k = 256 and its output cut
to the first k columns: for every k <= 256 it runs the same 256-list kernel
and returns exactly that cut (``pallas_topk.py:707`` and ``:753-757``), and
one call per k would compile the interpreted kernel twelve times.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyloo_tpu.ops.pallas_topk import pallas_topk_desc
from pyloo_tpu_torch import rcParams
from pyloo_tpu_torch.ops import topk
from pyloo_tpu_torch.ops.topk_profile import profile_topk_desc

KS = (1, 17, 191, 256)
VARIANTS = ("reshape", "natural")
PLAIN = {
    "reshape": topk.topk_desc_reshape_plain,
    "natural": topk.topk_desc_natural_plain,
}


@pytest.fixture(scope="module", autouse=True)
def _cpu_device():
    old = rcParams["device.device"]
    rcParams["device.device"] = "cpu"
    yield
    rcParams["device.device"] = old


@functools.cache
def _rows(s):
    """float32 rows: normal, a full-row tie, -inf entries, a Student-t row,
    and for each k a row that is -inf except k values."""
    rng = np.random.default_rng(s)
    x = rng.normal(-1.0, 0.8, size=(4 + len(KS), s))
    x[0] = 0.25  # full-row tie
    x[1, ::7] = -np.inf  # -inf entries, not the whole row
    x[2] = 2.0 * rng.standard_t(3, size=s) - 1.0  # heavy tail
    for r, k in enumerate(KS, start=4):
        keep = rng.choice(s, size=k, replace=False)
        x[r] = -np.inf
        x[r, keep] = rng.normal(size=k)
    return x.astype(np.float32)


@functools.cache
def _pallas(variant, s):
    got = pallas_topk_desc(jnp.asarray(_rows(s)), 256, variant=variant, interpret=True)
    return torch.from_numpy(np.array(got))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("s", [300, 1000, 4000])  # none a multiple of 256
@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_pallas_and_torch_topk(variant, s, k):
    x = torch.from_numpy(_rows(s))
    got = PLAIN[variant](x, k)
    assert got.shape == (x.shape[0], k)
    assert torch.equal(got, _pallas(variant, s)[:, :k])
    assert torch.equal(got, torch.topk(x, k, dim=1).values)


@pytest.mark.parametrize("variant", VARIANTS)
def test_plain_matches_torch_topk_across_segment_counts(variant):
    # 1 to 64 segments, and widths just past a power of two of segments
    rng = np.random.default_rng(7)
    for s in (2, 256, 257, 513, 2049, 16_000, 16_385):
        x = torch.from_numpy(rng.normal(size=(3, s)).astype(np.float32))
        k = min(s, 256)
        assert torch.equal(PLAIN[variant](x, k), torch.topk(x, k, dim=1).values), s


@pytest.mark.parametrize("variant", ["roll", *VARIANTS])
def test_topk_desc_on_cpu_returns_the_plain_version(variant):
    x = torch.from_numpy(_rows(1000))
    before = dict(topk.topk_desc.launches)
    got = topk.topk_desc(x, 191, variant=variant)
    plain = topk.topk_desc_plain if variant == "roll" else PLAIN[variant]
    assert torch.equal(got, plain(x, 191))
    assert topk.topk_desc.launches == before  # the CPU never launches a kernel


@pytest.mark.parametrize("variant", VARIANTS)
def test_k_above_256_raises_the_jax_message(variant):
    x = _rows(1000)
    with pytest.raises(ValueError) as jax_err:
        pallas_topk_desc(jnp.asarray(x), 257, variant=variant, interpret=True)
    with pytest.raises(ValueError) as port_err:
        topk.topk_desc(torch.from_numpy(x), 257, variant=variant)
    assert str(port_err.value) == str(jax_err.value)
    # "roll" takes k up to 1024
    assert topk.topk_desc(torch.from_numpy(x), 257, variant="roll").shape == (x.shape[0], 257)


def test_unknown_variant_and_s_cap_raise():
    x = torch.zeros((2, 1000))
    with pytest.raises(ValueError, match="unknown top-k variant 'bitonic'"):
        topk.topk_desc(x, 10, variant="bitonic")
    with pytest.raises(ValueError, match="S <= 32768"):
        topk.topk_desc(torch.zeros((2, topk.MAX_S + 1)), 10, variant="natural")


def test_profile_harness_raises_off_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        profile_topk_desc(8, 300, 17)  # rcParams["device.device"] is "cpu" here
    assert profile_topk_desc.launches == 0
