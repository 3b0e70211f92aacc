"""Batched moment matching on the device for the wrapper path.

Counterpart of ``pyloo_tpu/ops/moment_match.py`` (reference greedy loop:
``pyloo/loo_moment_match.py:384-561``): all bad observations run at once as
``(n_bad, S, P)`` tensors.  The affine transforms are batched linear algebra,
the PSIS re-fits go through :func:`pyloo_tpu_torch.ops.psis.psislw_batch`, and
the JAX program's vmapped ``lax.while_loop`` becomes a loop over passes with
an ``active`` mask: a lane whose loop condition is false keeps its state bit
for bit, as the JAX program's select gives it.

Semantics replicate the host loop (``pyloo_tpu_torch.loo_moment_match``):

* one pass tries shift, then shift-and-scale, then (optionally)
  shift-and-cov, each computed from the CURRENT (possibly just-updated)
  draws; a transform is accepted iff it strictly lowers Pareto k;
* a lane leaves when a full pass accepts nothing, k falls to the
  threshold, or the accepted-transform count passes ``max_iters``;
* Cholesky failure in the covariance transform gives that lane the
  identity mapping (``torch.linalg.cholesky_ex`` reports it per lane; the
  host loop runs the same transform on one lane and warns);
* any numerical failure in a candidate simply loses the ``k_new < k``
  comparison (host loop: per-transform ``try/except`` skip).

The tail length of :func:`batched_moment_match` is one per call.  A
:class:`_Lanes` may take each lane's own ``tail_length(S, r_eff_i)``
(``row_tails``, bounded by ``tail_max``), so lanes of every relative
efficiency run as one batch.
"""

from __future__ import annotations

import math

import torch

from ..parallel.sharding import device_scope
from ..profiling import count, span
from .guard import per_row
from .psis import psislw_batch

# the transforms of a pass, in order: shift, shift and scale, shift and covariance
KINDS = ("shift", "scale", "cov")

__all__ = [
    "batched_moment_match",
    "run_lanes",
    "split_transform_halves",
    "split_mixture_log_weights",
]


def split_transform_halves(upars, shift, scaling, mapping, mapping_inv, *, use_cov):
    """Split-MM draw matrices: forward transform on the first S/2 draws,
    inverse transform on the last S/2 (reference
    ``pyloo/split_moment_match.py:141-161``).

    The accumulated affine map is ``u -> (u - m) * scaling @ mapping.T + m +
    shift`` with ``m`` the draw mean; its inverse uses ``mapping_inv``.
    ``shift``, ``scaling`` (P) and the maps (P, P) may carry a leading axis
    of lanes, each lane's map applied to the same ``upars`` (S, P).

    Returns ``(half_fwd, half_inv)``: each is ``upars`` with one half
    replaced by the transformed draws, (S, P) or (lanes, S, P).
    """
    S = upars.shape[-2]
    half = S // 2
    mean = torch.mean(upars, dim=-2)
    centered = upars - mean[None, :]
    fwd = centered * scaling[..., None, :]
    if use_cov:
        fwd = fwd @ mapping.transpose(-1, -2)
    fwd = fwd + (shift + mean)[..., None, :]
    inv = centered
    if use_cov:
        inv = inv @ mapping_inv.transpose(-1, -2)
    inv = inv / scaling[..., None, :] + (mean - shift)[..., None, :]
    upars = upars.expand(fwd.shape)
    half_fwd = torch.cat([fwd[..., :half, :], upars[..., half:, :]], dim=-2)
    half_inv = torch.cat([upars[..., :half, :], inv[..., half:, :]], dim=-2)
    return half_fwd, half_inv


def split_mixture_log_weights(log_liki, log_prob_fwd, log_prob_inv_adj):
    """Deterministic two-component-mixture importance log-weights.

    The proposal is the 50/50 mixture of the forward- and inverse-
    transformed halves, so the unnormalized log-weight of draw s is
    ``-log p(y_i|s) + log p(s) - log(p_fwd(s) + p_inv(s))`` (the mixture 1/2
    cancels in PSIS normalization).  ``log_prob_inv_adj`` must already carry
    the inverse map's Jacobian correction.  NaN / +inf weights collapse to
    -inf (reference ``pyloo/split_moment_match.py:220-242``).
    """
    lwi = -log_liki + log_prob_fwd - torch.logaddexp(log_prob_fwd, log_prob_inv_adj)
    bad = torch.isnan(lwi) | (lwi == math.inf)
    return torch.where(bad, -math.inf, lwi)


def _plain_cov(x):
    """``np.cov(x, rowvar=False)`` (ddof=1) of each ``(S, P)`` matrix in a batch."""
    S = x.shape[-2]
    xm = x - torch.mean(x, dim=-2, keepdim=True)
    return xm.transpose(-1, -2) @ xm / (S - 1)


def _weighted_cov(x, w):
    """``np.cov(x, rowvar=False, aweights=w)`` of each matrix in a batch."""
    v1 = torch.sum(w, dim=-1)
    v2 = torch.sum(w * w, dim=-1)
    mu = torch.sum(w[..., None] * x, dim=-2) / v1[..., None]
    xm = x - mu[..., None, :]
    return (w[..., None] * xm).transpose(-1, -2) @ xm / (v1 - v2 / v1)[..., None, None]


def _transform(uparsi, lwi, kind: int):
    """One affine moment-matching transform of each lane's draw matrix.

    ``uparsi`` (n, S, P), ``lwi`` (n, S).  kind 0: weighted-mean shift;
    1: + marginal scale; 2: + covariance via the Cholesky map
    ``L_w L^-1`` from a triangular solve.  The host transforms of
    :mod:`pyloo_tpu_torch.loo_moment_match` run it on one lane, so the host
    loop and the batched loop transform their draws with the same arithmetic.

    Returns (upars_new, shift, scaling, mapping, ok), batched over lanes;
    ``ok`` is False on a lane whose Cholesky factorisation failed (its
    mapping is then the identity).
    """
    n, S, P = uparsi.shape
    w = torch.exp(lwi)
    mean_original = torch.mean(uparsi, dim=1)
    mean_weighted = torch.sum(w[..., None] * uparsi, dim=1)
    shift = mean_weighted - mean_original
    eye = torch.eye(P, dtype=uparsi.dtype, device=uparsi.device).expand(n, P, P)
    ones = torch.ones((n, P), dtype=uparsi.dtype, device=uparsi.device)
    ok = torch.ones((n,), dtype=torch.bool, device=uparsi.device)

    if kind == 0:
        return uparsi + shift[:, None, :], shift, ones, eye, ok

    if kind == 1:
        mii = torch.sum(w[..., None] * uparsi**2, dim=1) - mean_weighted**2
        mii = mii * S / (S - 1)
        scaling = torch.sqrt(mii / torch.var(uparsi, dim=1, correction=0))
        new = (uparsi - mean_original[:, None, :]) * scaling[:, None, :] + (
            mean_weighted[:, None, :]
        )
        return new, shift, scaling, eye, ok

    covv = _plain_cov(uparsi)
    wcovv = _weighted_cov(uparsi, w)
    chol1, info1 = torch.linalg.cholesky_ex(wcovv)
    chol2, info2 = torch.linalg.cholesky_ex(covv)
    # chol1 @ chol2^{-1} as the solution X of X @ chol2 = chol1
    mapping = torch.linalg.solve_triangular(chol2, chol1, upper=False, left=False)
    # a lane whose factorisation failed takes the identity mapping
    ok = (info1 == 0) & (info2 == 0) & torch.isfinite(mapping).all(dim=(-2, -1))
    mapping = torch.where(ok[:, None, None], mapping, eye)
    new = (uparsi - mean_original[:, None, :]) @ mapping.transpose(-1, -2) + (
        mean_weighted[:, None, :]
    )
    return new, shift, ones, mapping, ok


class _Lanes:
    """The greedy loop's state for a set of lanes on one device, one pass
    at a time: :meth:`step` queues a pass, ``active`` says (on the device)
    which lanes go on."""

    def __init__(self, upars, obs_idx, orig_log_prob, log_liki0, lwi0, ki0,
                 k_threshold: float, *, log_prob_fn, log_lik_col_fn, tail_max: int,
                 max_iters: int, use_cov: bool, row_tails=None):
        n = obs_idx.shape[0]
        S, P = upars.shape
        dtype, device = upars.dtype, upars.device
        self.st = {
            "upars": upars.expand(n, S, P),
            "lwi": lwi0,
            "ki": ki0,
            "kfi": torch.zeros((n,), dtype=dtype, device=device),
            "log_liki": log_liki0,
            "total_shift": torch.zeros((n, P), dtype=dtype, device=device),
            "total_scaling": torch.ones((n, P), dtype=dtype, device=device),
            "total_mapping": torch.eye(P, dtype=dtype, device=device).expand(n, P, P),
        }
        self.iterind = torch.ones((n,), dtype=torch.int64, device=device)
        # what the result reports besides: each lane's accepted transforms by
        # kind, and whether its covariance map ever fell back to the identity
        self.accepted = torch.zeros((n, len(KINDS)), dtype=torch.int64, device=device)
        self.cov_failed = torch.zeros((n,), dtype=torch.bool, device=device)
        self.obs_idx, self.orig_log_prob = obs_idx, orig_log_prob
        self.k_threshold, self.max_iters, self.tail_max = k_threshold, max_iters, tail_max
        self.row_tails = row_tails
        self.log_prob_fn, self.log_lik_col_fn = log_prob_fn, log_lik_col_fn
        self.kinds = (0, 1, 2) if use_cov else (0, 1)
        self.active = (self.iterind <= max_iters) & (self.st["ki"] > k_threshold)

    def step(self) -> None:
        """One pass over the transforms, for the active lanes."""
        st, active, n = self.st, self.active, self.obs_idx.shape[0]

        def upd(accept, new, old):
            return torch.where(accept.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

        progressing = torch.zeros((n,), dtype=torch.bool, device=active.device)
        for kind in self.kinds:
            new_upars, shift, scaling, mapping, ok = _transform(st["upars"], st["lwi"], kind)
            count("mm_evals", "loop", new_upars.shape[0] * new_upars.shape[1])
            log_prob_new = self.log_prob_fn(new_upars)
            log_liki_new = self.log_lik_col_fn(new_upars, self.obs_idx)
            lr = -log_liki_new + log_prob_new - self.orig_log_prob[None, :]
            lr = torch.where(torch.isnan(lr), -math.inf, lr)
            full_lr = log_prob_new - self.orig_log_prob[None, :]
            full_lr = torch.where(torch.isnan(full_lr), -math.inf, full_lr)
            with per_row():  # a lane's float64 guard is its own, as under jax.vmap
                lwi_new, ki_new = psislw_batch(lr, self.tail_max, self.row_tails)
                _, kfi_new = psislw_batch(full_lr, self.tail_max, self.row_tails)

            # NaN candidates lose (host: skip); inactive lanes keep their state
            accept = active & (ki_new < st["ki"])
            st = {
                "upars": upd(accept, new_upars, st["upars"]),
                "lwi": upd(accept, lwi_new, st["lwi"]),
                "ki": upd(accept, ki_new, st["ki"]),
                "kfi": upd(accept, kfi_new, st["kfi"]),
                "log_liki": upd(accept, log_liki_new, st["log_liki"]),
                "total_shift": upd(accept, st["total_shift"] + shift, st["total_shift"]),
                "total_scaling": upd(
                    accept, st["total_scaling"] * scaling, st["total_scaling"]
                ),
                "total_mapping": upd(
                    accept, mapping @ st["total_mapping"], st["total_mapping"]
                ),
            }
            self.iterind = self.iterind + accept.to(self.iterind.dtype)
            self.accepted[:, kind] += accept.to(self.accepted.dtype)
            if KINDS[kind] == "cov":
                self.cov_failed = self.cov_failed | (active & ~ok)
            progressing = progressing | accept
        self.st = st
        self.active = (active & (self.iterind <= self.max_iters)
                       & (st["ki"] > self.k_threshold) & progressing)

    def result(self) -> dict:
        out = {k: v for k, v in self.st.items() if k != "upars"}
        out["n_accepted"] = self.iterind - 1
        out["reached_max"] = self.iterind > self.max_iters
        out["accepted_by_kind"] = self.accepted
        out["cov_failed"] = self.cov_failed
        return out

    def active_lanes(self) -> int:
        """The lanes that go on, read on the host: the loop's one read a pass."""
        count("host_reads", "moment_match.pass")
        return int(self.active.sum())


def run_lanes(lanes: list) -> int:
    """Run the greedy loops of lane sets on their devices side by side, and
    return the passes run.  A pass is queued on every device whose lanes go
    on before any is read: one host read a device a pass.  Under a profiler
    each pass is a ``pyloo.moment_match.pass`` span carrying its number
    ``p``, and ``mm_lane_passes`` counts the lanes each pass works on."""
    going = [lane.active_lanes() for lane in lanes]
    passes = 0
    while any(going):
        with span("pyloo.moment_match.pass", p=passes):
            passes += 1
            count("mm_lane_passes", "loop", sum(going))
            for lane, on in zip(lanes, going):
                if on:
                    with device_scope(lane.active.device):
                        lane.step()
            going = [lane.active_lanes() if on else 0 for lane, on in zip(lanes, going)]
    count("mm_passes", "batched", passes)
    return passes


def batched_moment_match(
    upars,
    obs_idx,
    orig_log_prob,
    log_liki0,
    lwi0,
    ki0,
    k_threshold: float,
    *,
    log_prob_fn,
    log_lik_col_fn,
    tail_max: int,
    max_iters: int,
    use_cov: bool,
):
    """Greedy moment matching for every bad observation, on the device.

    Parameters
    ----------
    upars : (S, P) tensor
        Unconstrained posterior draws (shared starting point).
    obs_idx : (n_bad,) int64 tensor
        Observation indices with k above the threshold.
    orig_log_prob : (S,)
        Log joint density of the ORIGINAL draws.
    log_liki0 : (n_bad, S)
        Log likelihood of each bad observation at the original draws.
    lwi0 : (n_bad, S)
        Initial smoothed normalized log weights per bad observation.
    ki0 : (n_bad,)
        Initial Pareto k per bad observation.
    k_threshold : float
    log_prob_fn : callable
        ``(n_bad, S, P) -> (n_bad, S)`` log joint density.
    log_lik_col_fn : callable
        ``((n_bad, S, P), obs_idx) -> (n_bad, S)``: each lane's observation's
        log likelihood at its draws.
    tail_max : int
        Shared PSIS tail budget of these lanes.

    Returns
    -------
    dict with per-observation finals: ``lwi``, ``ki``, ``kfi``,
    ``log_liki``, ``total_shift``, ``total_scaling``, ``total_mapping``,
    ``n_accepted`` (= iterind - 1), ``reached_max``, ``accepted_by_kind``
    (n_bad, 3: the accepted shifts, scales and covariance maps) and
    ``cov_failed`` (whether an active lane's covariance map fell back to
    the identity); and ``passes``, the passes run (an int).

    The loop reads one count on the host a pass (how many lanes are still
    active): at most ``max_iters + 1`` reads, since an active lane has
    accepted at least one transform in each earlier pass.  In float64 each
    re-fit also reads its lanes' deep-tail flags, once (each lane takes its
    own branch of the guard, as under ``jax.vmap``).  Sharded over
    devices, the lanes are sets of their own run by :func:`run_lanes`.
    """
    lanes = _Lanes(upars, obs_idx, orig_log_prob, log_liki0, lwi0, ki0, k_threshold,
                   log_prob_fn=log_prob_fn, log_lik_col_fn=log_lik_col_fn,
                   tail_max=tail_max, max_iters=max_iters, use_cov=use_cov)
    passes = run_lanes([lanes])
    out = lanes.result()
    out["passes"] = passes
    return out
