"""Non-factorised LOO with the draws' matrices made on the device a chunk at a time.

:func:`pyloo_tpu_torch.loo_nonfactor` takes every draw's ``(N, N)``
covariance or precision in an InferenceData on the host; at N = 2,048 and
4,000 draws that is 134 GB, more than a card or a workstation holds.  A
Gaussian-process or spatial model has draws of a few parameters, not of
matrices, so :func:`loo_nonfactor_streaming` takes the matrices from a
function of the draw indices, as :func:`pyloo_tpu_torch.loo_streaming`
takes the log-likelihood from a function of the observation indices::

    d2 = (x[:, None] - x[None, :]) ** 2          # (N, N), on the device

    def cov_fn(idx):                             # (chunk,) int64 draw indices
        a, rho, s = theta[idx].unbind(1)         # theta: (S, 3) on the device
        k = a[:, None, None] ** 2 * torch.exp(-0.5 * d2 / rho[:, None, None] ** 2)
        return k + s[:, None, None] ** 2 * torch.eye(len(x), device=idx.device)

    res = pyloo_tpu_torch.loo_nonfactor_streaming(y, 0.0, cov_fn, S, chains=4)

The chunks of draws, the conditional log-likelihoods and everything after
them (the dropped draws, the weights, the totals, the report) are those of
``loo_nonfactor`` (:func:`pyloo_tpu_torch.ops.nonfactor.conditional_loglik`,
``loo_nonfactor._nonfactor_result``): on the same matrices the two give the
same estimate bit for bit.  The ``(S, N)`` log-likelihoods stay on the
device until the scores.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .._common import compute_device, resolve_scale
from ..base import ISMethod
from ..elpd import ELPDData
from ..loo_nonfactor import _nonfactor_result
from ..ops.nonfactor import conditional_loglik
from ..parallel.sharding import as_mesh
from ..profiling import count, span
from ._chunks import generate

__all__ = ["loo_nonfactor_streaming"]


def _per_draw(x, shape: tuple, name: str, device: torch.device) -> torch.Tensor:
    """``x`` as a float64 tensor broadcast to ``shape``: a tensor where it
    lies, an array or a number copied to ``device`` once (so that no chunk
    waits for a copy from host memory)."""
    if isinstance(x, torch.Tensor):
        t = x.to(dtype=torch.float64)
    else:
        t = torch.as_tensor(np.asarray(x, dtype=np.float64))
        count("h2d_bytes", "draws", t.numel() * t.element_size())
        t = t.to(device)
    try:
        return t.expand(shape)
    except RuntimeError:
        raise ValueError(
            f"{name} of shape {tuple(t.shape)} does not broadcast to {shape}"
        ) from None


def loo_nonfactor_streaming(
    y,
    mu,
    matrix_fn,
    n_draws: int,
    *,
    chains: int = 1,
    form: str = "cov",
    model_type: str = "normal",
    df=None,
    reff: float = 1.0,
    pointwise: bool = False,
    method: str | ISMethod = "psis",
    scale: str | None = None,
    mesh=None,
) -> ELPDData:
    """LOO-CV of a joint MVN or multivariate-t model whose draws' covariance
    or precision matrices ``matrix_fn`` makes on the device.

    Parameters
    ----------
    y : (N,) array or tensor
        The observations.
    mu : array or tensor
        The draws' means, ``(n_draws, N)``, or anything that broadcasts to
        it (a scalar, an ``(N,)`` mean shared by every draw).
    matrix_fn : callable
        Maps an int64 tensor ``idx`` of draw indices (a chunk of
        ``ops.nonfactor.draws_per_chunk(N)`` draws; over a ``mesh`` on the
        chunk's device) to the ``(len(idx), N, N)`` covariances
        (``form="cov"``) or precisions (``form="prec"``) of those draws, a
        tensor on ``idx.device``; it is cast to float64.
    n_draws : int
        Draws in all, stacked ``chain * (n_draws // chains) + draw``, the
        order in which ``loo_nonfactor`` stacks an InferenceData's.
    chains : int
        Chains the draws come from; ``n_draws`` must be a multiple of it.
    form : {"cov", "prec"}
    model_type : {"normal", "student_t"}
    df : (n_draws,) array or tensor, optional
        The degrees of freedom of a Student-t model; draws with ``df <= 0``
        are dropped, with a warning.
    reff : float
        Relative MCMC efficiency (PSIS tail sizing), a number: the ESS of
        every matrix element that ``loo_nonfactor`` computes when it is
        given none needs the matrices on the host.
    pointwise : bool
        Also return ``loo_i`` and the diagnostic of each observation.
    method : {"psis", "sis", "tis"}
    scale : {"log", "negative_log", "deviance"}, optional
    mesh : Mesh, optional
        :class:`pyloo_tpu_torch.parallel.Mesh`: the chunks of draws are dealt
        over its devices in turn, as ``loo_nonfactor`` deals them; the
        estimate equals one device's bit for bit.

    Returns
    -------
    ELPDData with the rows of :func:`pyloo_tpu_torch.loo_nonfactor`'s.
    """
    with span("pyloo.loo_nonfactor"):
        warnings.warn(
            f"loo_nonfactor() with model_type='{model_type}' requires the correct model"
            " specification. Using this function with mismatched models will produce"
            " incorrect results.",
            UserWarning,
            stacklevel=2,
        )
        if model_type not in ("normal", "student_t"):
            raise ValueError(
                f"model_type must be 'normal' or 'student_t', got {model_type!r}"
            )
        if form not in ("cov", "prec"):
            raise ValueError(f"form must be 'cov' or 'prec', got {form!r}")
        if not callable(matrix_fn):
            raise TypeError(
                f"matrix_fn must be a function of draw indices, got {type(matrix_fn).__name__}"
            )
        n_draws, chains = int(n_draws), int(chains)
        if n_draws < 2:
            raise ValueError("PSIS requires at least 2 draws per observation.")
        if chains < 1 or n_draws % chains:
            raise ValueError(f"n_draws ({n_draws}) must be a multiple of chains ({chains})")
        mesh = as_mesh(mesh, "loo_nonfactor_streaming")
        scale, scale_value = resolve_scale(scale)
        try:
            method = method if isinstance(method, ISMethod) else ISMethod(method.lower())
        except ValueError:
            valid_methods = ", ".join(m.value for m in ISMethod)
            raise ValueError(f"Invalid method '{method}'. Must be one of: {valid_methods}")
        device = compute_device()
        y = torch.as_tensor(y, dtype=torch.float64)
        if y.dim() != 1:
            raise ValueError(f"y must be 1-dimensional (N,). Found shape {tuple(y.shape)}.")
        n = y.shape[0]
        mu = _per_draw(mu, (n_draws, n), "mu", device)
        df_t = bad_df = None
        if model_type == "student_t":
            if df is None:
                raise ValueError("model_type='student_t' needs the draws' degrees of freedom, df")
            df_t = _per_draw(df, (n_draws,), "df", device)
            bad_df = df_t <= 0
            df_t = torch.where(bad_df, 1.0, df_t)
        if method != ISMethod.PSIS:
            warnings.warn(
                f"Using {method.value.upper()} for LOO computation. Note that PSIS is the"
                " recommended method as it is typically more efficient and reliable.",
                UserWarning,
                stacklevel=2,
            )

        def source(idx):
            return generate(matrix_fn, idx, (idx.shape[0], n, n), torch.float64, "matrix_fn")

        ll, failed = conditional_loglik(y, mu, source, form=form, df=df_t, mesh=mesh)
        return _nonfactor_result(
            ll, failed, bad_df, form=form, model_type=model_type, method=method,
            reff=float(reff), scale=scale, scale_value=scale_value, pointwise=pointwise,
            obs_dim="obs", obs_coord={},
        )
