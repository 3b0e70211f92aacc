"""The fixed work of a moment-matching call and the peaks it is set against.

Whatever implements it, a pass of the greedy loop that a flagged row (a
lane) works on tries three transforms of the lane's ``(S, P)`` draws: each
reads the draws once and writes the new ones once, and the candidate's log
density reads them once more (the evaluations' bytes).  The covariance
transform forms the plain and the weighted covariance of the draws (two
``S x P x P`` products), factorises both (``P^3 / 3`` each), solves for the
map ``L_w L^-1`` (``P^3``), applies it to the draws (an ``S x P x P``
product) and folds it into the lane's total map (``2 P^3``).  A lane's split
transform inverts its total map and takes its determinant (``2 P^3`` and
``2 P^3 / 3``), maps the two halves of the draws (``2 S P^2`` in all),
reads the draws and writes the two halves, and evaluates them.  The float64
work is set against the H100 SXM's float64 tensor-core peak and the bytes
against its HBM rate (NVIDIA's data sheet, dense, at 700 W): the least time
of the call is the longer of the two.  The counts of lane-passes and split
lanes are the program's counters of the call (``mm_lane_passes``,
``mm_split_lanes``), which the seed fixes.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.factor_work import FP64_TC_FLOPS_PER_S
from benchmark.measure import HBM_BYTES_PER_S

TRANSFORMS = 3  # shift, shift and scale, shift and covariance


@dataclass
class Work:
    """A call's shapes: ``n_draws`` S, ``n_params`` P, ``n_obs`` N."""

    n_draws: int
    n_params: int
    n_obs: int

    def pass_flops(self) -> float:
        """Float64 operations of one lane's covariance transform."""
        s, p = self.n_draws, self.n_params
        return 3 * 2.0 * s * p * p + (2.0 / 3.0 + 1.0 + 2.0) * p ** 3

    def pass_bytes(self) -> float:
        """Bytes of one lane-pass: each transform's draws read and written,
        and read again by the candidate's log density."""
        return TRANSFORMS * 3 * 8.0 * self.n_draws * self.n_params

    def split_flops(self) -> float:
        s, p = self.n_draws, self.n_params
        return 2.0 * s * p * p + (2.0 + 2.0 / 3.0) * p ** 3

    def split_bytes(self) -> float:
        """The draws read, the two halves written and both evaluated."""
        return 5 * 8.0 * self.n_draws * self.n_params

    def least_seconds(self, lane_passes: float, split_lanes: float) -> float:
        flops = lane_passes * self.pass_flops() + split_lanes * self.split_flops()
        n_bytes = lane_passes * self.pass_bytes() + split_lanes * self.split_bytes()
        return max(flops / FP64_TC_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S)
