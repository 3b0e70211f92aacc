"""ELPD result container with the ``loo`` report format.

Counterpart of ``pyloo_tpu/elpd.py`` without pandas: :class:`ELPDData` is a
small ordered container of named rows in place of a ``pandas.Series``.  It
keeps the behaviour ``loo()`` results are used with (indexing by name,
attribute access to rows, ``in``, ``get``) and renders the same report
strings byte for byte (reference ``pyloo/elpd.py:10-97`` templates).  The
``loo`` (standard, mixture and approximate-posterior), subsampled ``loo``,
``waic``, ``logo``, ``lfo``, ``kfold``, generic ``elpd`` and
non-factorised (``loo_nonfactor``) kinds are rendered.
"""

from __future__ import annotations

from copy import copy as _copy
from copy import deepcopy as _deepcopy

import numpy as np

__all__ = ["ELPDData"]

STD_BASE_FMT = """
Computed from {n_samples} posterior samples and {n_points} observations log-likelihood matrix.

         Estimate       SE
elpd_loo   {elpd:<8.2f}    {se:<.2f}
p_loo       {p_loo:<8.2f}    {p_loo_se:<.2f}
looic      {looic:<8.2f}    {looic_se:<.2f}"""

MVN_BASE_FMT = """
Computed from {n_samples} posterior samples and {n_points} observations log-likelihood matrix.
Using non-factorized multivariate normal model.

         Estimate       SE
elpd_loo   {elpd:<8.2f}    {se:<.2f}
p_loo       {p_loo:<8.2f}    {p_loo_se:<.2f}
looic      {looic:<8.2f}    {looic_se:<.2f}"""

MVT_BASE_FMT = """
Computed from {n_samples} posterior samples and {n_points} observations log-likelihood matrix.
Using non-factorized multivariate Student-t model.

         Estimate       SE
elpd_loo   {elpd:<8.2f}    {se:<.2f}
p_loo       {p_loo:<8.2f}    {p_loo_se:<.2f}
looic      {looic:<8.2f}    {looic_se:<.2f}"""

SUBSAMPLE_BASE_FMT = """
Computed from {n_samples} by {subsample_size} subsampled log-likelihood
values from {n_data_points} total observations.

         Estimate       SE  subsampling SE
elpd_loo   {elpd_loo:<8.2f}    {elpd_loo_se:<.2f}         {elpd_loo_subsamp_se:<.2f}
p_loo       {p_loo:<8.2f}    {p_loo_se:<.2f}         {p_loo_subsamp_se:<.2f}
looic      {looic:<8.2f}    {looic_se:<.2f}         {looic_subsamp_se:<.2f}
{pareto_msg}"""

APPROX_POSTERIOR_FMT = """
Computed from {n_samples} posterior samples and {n_points} observations log-likelihood matrix.
Posterior approximation correction used.
------

         Estimate       SE
elpd_loo   {elpd:<8.2f}    {se:<.2f}
p_loo       {p_loo:<8.2f}    {p_loo_se:<.2f}
looic      {looic:<8.2f}    {looic_se:<.2f}"""

# Generic held-out-data ELPD (R loo::elpd parity; no reference analogue).
GENERIC_ELPD_FMT = """
Computed from {n_samples} by {n_points} log-likelihood matrix using the generic elpd function.

     Estimate       SE
elpd   {elpd:<8.2f}    {se:<.2f}
ic     {ic:<8.2f}    {ic_se:<.2f}"""

KFOLD_BASE_FMT = """
Computed from {n_samples} posterior samples using {K}-fold cross-validation
with {n_points} observations.{stratify_msg}

           Estimate       SE
elpd_kfold   {elpd:<8.2f}    {se:<.2f}
p_kfold       {p_kfold:<8.2f}    {p_kfold_se:<.2f}
kfoldic      {kfoldic:<8.2f}    {kfoldic_se:<.2f}
"""

# LFO-CV is a pyloo_tpu extension (no reference analogue)
LFO_BASE_FMT = """
Computed from {n_samples} posterior samples: {n_targets} {M}-step-ahead predictions with history >= {L} observations ({n_refits} exact refits).

         Estimate       SE
elpd_lfo   {elpd:<8.2f}    {se:<.2f}
lfoic      {lfoic:<8.2f}    {lfoic_se:<.2f}"""

LOGO_BASE_FMT = """
Computed from {n_samples} posterior samples and {n_groups} groups log-likelihood matrix.

         Estimate       SE
elpd_logo   {elpd:<8.2f}    {se:<.2f}
p_logo       {p_logo:<8.2f}    {p_logo_se:<.2f}
logoic      {logoic:<8.2f}    {logoic_se:<.2f}"""

WAIC_BASE_FMT = """
Computed from {n_samples} posterior samples and {n_points} observations log-likelihood matrix.

          Estimate       SE
elpd_waic   {elpd:<8.2f}    {se:<.2f}
p_waic       {p_waic:<8.2f}    -
waic       {waicic:<8.2f}    {waicic_se:<.2f}"""

MIXTURE_BASE_FMT = """
Computed from {n_samples} posterior samples and {n_points} observations log-likelihood matrix with
mixture posterior.

         Estimate       SE
elpd_loo   {elpd:<8.2f}    -"""

POINTWISE_LOO_FMT = """
------

Pareto k diagnostic values:
                         Count   Pct.
(-Inf, {2:.2f}]   (good)      {3:d}   {6:.1f}%
   ({2:.2f}, 1]   (bad)         {4:d}    {7:.1f}%
   (1, Inf)   (very bad)    {5:d}    {8:.1f}%"""

_WARNING_NOTE = (
    "\n\nThere has been a warning during the calculation. Please check the"
    " results."
)


def _khat_counts(pareto_k, good_k):
    """Histogram k values into (good, bad, very bad] bins."""
    values = np.asarray(
        pareto_k.values if hasattr(pareto_k, "values") else pareto_k
    ).ravel()
    edges = np.array([-np.inf, good_k, 1.0, np.inf])
    counts, _ = np.histogram(values, bins=edges)
    return counts


def _khat_table(pareto_k, good_k):
    counts = _khat_counts(pareto_k, good_k)
    pct = counts / counts.sum() * 100
    return POINTWISE_LOO_FMT.format(
        "Count", "Pct.", good_k, counts[0], counts[1], counts[2],
        pct[0], pct[1], pct[2],
    )


def _all_good_msg(good_k):
    return (
        f"\n\nAll Pareto k estimates are good (k < {good_k:.1f})."
        "\nSee help('pareto-k-diagnostic') for details."
    )


def _pareto_section(data):
    """Common k-diagnostic tail: histogram table, or the all-good message."""
    good_k = data.get("good_k")
    if "pareto_k" in data and good_k is not None:
        counts = _khat_counts(data.pareto_k, good_k)
        if counts[1] == 0 and counts[2] == 0:
            return _all_good_msg(good_k), True
        return _khat_table(data.pareto_k, good_k), False
    return "", None


# what an attribute that a result of another kind sets reads on a plain
# loo() result, as in pyloo_tpu (elpd.py:404-442): no groups, PSIS, no folds
_ATTR_DEFAULTS = {"n_groups": None, "method": "psis", "K": None, "stratified": False}


class ELPDData:
    """Expected log pointwise predictive density results.

    Ordered rows (``elpd_loo``, ``se``, ``p_loo``, ..., and pointwise
    ``loo_i`` / ``pareto_k`` when requested), reachable as ``res["name"]``
    and ``res.name``.  Setting an attribute that is not a row stores plain
    metadata (``fast_path_degenerate``), as on a ``pandas.Series``.
    """

    def __init__(self, data, index):
        object.__setattr__(self, "_rows", dict(zip(index, data)))

    # -- container behaviour ------------------------------------------------
    def __getitem__(self, key):
        return self._rows[key]

    def __setitem__(self, key, value):
        self._rows[key] = value

    def __contains__(self, key):
        return key in self._rows

    def __len__(self):
        return len(self._rows)

    def __iter__(self):
        return iter(self._rows.values())  # a Series iterates over its values

    def __getattr__(self, name):
        rows = self.__dict__.get("_rows", {})
        if name in rows:
            return rows[name]
        if name in _ATTR_DEFAULTS:
            return _ATTR_DEFAULTS[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._rows:
            self._rows[name] = value
        else:
            object.__setattr__(self, name, value)

    @property
    def index(self):
        return list(self._rows)

    def get(self, key, default=None):
        return self._rows.get(key, default)

    def copy(self, deep=True):
        dup = _deepcopy if deep else _copy
        out = ELPDData([dup(v) for v in self._rows.values()], list(self._rows))
        for name, value in self.__dict__.items():
            if name != "_rows":
                object.__setattr__(out, name, dup(value))
        return out

    # -- report -------------------------------------------------------------
    def __str__(self):
        first = self.index[0]
        if first == "elpd":  # generic held-out elpd
            return GENERIC_ELPD_FMT.format(
                n_samples=self.n_samples,
                n_points=self.n_data_points,
                elpd=self["elpd"],
                se=self["se"],
                ic=self["ic"],
                ic_se=self["ic_se"],
            )
        if first == "elpd_waic":
            return self._format_waic()
        if first == "elpd_logo":
            return self._format_logo()
        if first == "elpd_lfo":
            return self._format_lfo()
        if first == "elpd_kfold":
            return self._format_kfold()
        if first != "elpd_loo":
            raise NotImplementedError(
                "pyloo_tpu_torch renders loo (with its mixture, approximate-posterior and"
                " non-factorised kinds), subsampled loo, waic, logo, lfo, kfold and generic"
                f" elpd results, not a result whose first row is {first!r}"
            )
        if "subsampling_SE" in self:
            return self._format_subsample()
        return self._format_loo()

    def __repr__(self):
        return self.__str__()

    def _format_kfold(self):
        elpd = self["elpd_kfold"]
        se = self["se"]
        stratify_msg = (
            " Using stratified k-fold cross-validation" if self.stratified else ""
        )
        base = KFOLD_BASE_FMT.format(
            n_samples=self.n_samples,
            K=self.get("K"),
            n_points=self.n_data_points,
            elpd=elpd,
            se=se,
            p_kfold=self["p_kfold"],
            p_kfold_se=self["p_kfold_se"],
            kfoldic=-2 * elpd,
            kfoldic_se=2 * se,
            stratify_msg=stratify_msg,
        )
        if self.warning:
            base += _WARNING_NOTE
        return base

    def _format_waic(self):
        elpd = self["elpd_waic"]
        se = self["se"]
        base = WAIC_BASE_FMT.format(
            n_samples=self.n_samples,
            n_points=self.n_data_points,
            elpd=elpd,
            se=se,
            p_waic=self["p_waic"],
            waicic=-2 * elpd,
            waicic_se=2 * se,
        )
        if self.warning:
            base += _WARNING_NOTE
        return base

    def _format_logo(self):
        base = LOGO_BASE_FMT.format(
            n_samples=self.n_samples,
            n_groups=self["n_groups"],
            elpd=self["elpd_logo"],
            se=self["se"],
            p_logo=self["p_logo"],
            p_logo_se=self.get("p_logo_se", float("nan")),
            logoic=self["logoic"],
            logoic_se=self["logoic_se"],
        )
        if self.warning:
            base += _WARNING_NOTE
        section, _ = _pareto_section(self)
        return base + section

    def _format_lfo(self):
        base = LFO_BASE_FMT.format(
            n_samples=self.n_samples,
            n_targets=self.n_data_points,
            M=self.get("M", 1),
            L=self.get("L", "?"),
            n_refits=self.get("n_refits", 0),
            elpd=self["elpd_lfo"],
            se=self["se"],
            lfoic=self["lfoic"],
            lfoic_se=self["lfoic_se"],
        )
        if self.warning:
            base += _WARNING_NOTE
        section, _ = _pareto_section(self)
        return base + section

    def _format_subsample(self):
        pareto_msg = (
            "\n\nAll Pareto k estimates are good (k < 0.7).\nSee"
            " help('pareto-k-diagnostic') for details."
        )
        section, all_good = _pareto_section(self)
        if all_good is False:
            pareto_msg = section  # the reference keeps the 0.7 message when all are good

        elpd_loo = self["elpd_loo"]
        elpd_loo_se = self["se"]
        elpd_loo_subsamp_se = self["subsampling_SE"]
        base = SUBSAMPLE_BASE_FMT.format(
            elpd_loo=elpd_loo,
            elpd_loo_se=elpd_loo_se,
            elpd_loo_subsamp_se=elpd_loo_subsamp_se,
            p_loo=self["p_loo"],
            p_loo_se=self.get("p_loo_se", float("nan")),
            p_loo_subsamp_se=self.get("p_loo_subsampling_se", float("nan")),
            looic=-2 * elpd_loo,
            looic_se=2 * elpd_loo_se,
            looic_subsamp_se=2 * elpd_loo_subsamp_se,
            n_samples=self.n_samples,
            subsample_size=self["subsample_size"],
            n_data_points=self.n_data_points,
            pareto_msg=pareto_msg,
        )
        if self.warning:
            base += _WARNING_NOTE
        return base

    def _format_loo(self):
        pareto_msg, all_good = _pareto_section(self)
        # pyloo_tpu's loo() never sets a method, so its report takes the
        # psis branch here for sis and tis results too
        if all_good is None:
            if self.warning:
                pareto_msg = (
                    "\n\nSome Pareto k diagnostic values are high (k > 0.70),"
                    " indicating that the importance sampling approximation is"
                    " unreliable. Consider using moment matching or exact LOO"
                    " for more accurate estimates. Use pointwise=True to see"
                    " detailed diagnostics."
                )
            else:
                pareto_msg = (
                    "\n\nAll Pareto k estimates are good (k <"
                    " 0.7).\nSee help('pareto-k-diagnostic') for details."
                )

        if "approximate_posterior" in self.__dict__:
            base = APPROX_POSTERIOR_FMT.format(
                n_samples=self.n_samples,
                n_points=self.n_data_points,
                elpd=self["elpd_loo"],
                se=self["se"],
                p_loo=self["p_loo"],
                p_loo_se=self["p_loo_se"],
                looic=self["looic"],
                looic_se=self["looic_se"],
            )
        elif "p_loo" not in self:
            base = MIXTURE_BASE_FMT.format(
                n_samples=self.n_samples,
                n_points=self.n_data_points,
                elpd=self["elpd_loo"],
            )
        else:
            attrs = self.__dict__.get("attrs") or {}
            if attrs.get("is_mvn", False):  # loo_nonfactor
                fmt = MVT_BASE_FMT if attrs.get("model_type") == "student_t" else MVN_BASE_FMT
            else:
                fmt = STD_BASE_FMT
            base = fmt.format(
                n_samples=self.n_samples,
                n_points=self.n_data_points,
                elpd=self["elpd_loo"],
                se=self["se"],
                p_loo=self["p_loo"],
                p_loo_se=self["p_loo_se"],
                looic=self["looic"],
                looic_se=self["looic_se"],
            )
        if self.warning:
            base += _WARNING_NOTE
        return base + pareto_msg
