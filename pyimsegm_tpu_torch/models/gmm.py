"""Gaussian-mixture prediction (the predict side of
``pyimsegm_tpu.models.gmm``).  Fitting is a later slice of ROADMAP.md."""

from typing import NamedTuple

import torch

_LOG2PI = 1.8378770664093453


class GMMParams(NamedTuple):
    weights: torch.Tensor    # (C,)
    means: torch.Tensor      # (C, D)
    covs: torch.Tensor       # (C, D, D)


def _chol_log_prob(x, means, covs):
    """log N(x | mu_c, Sigma_c) for all components: (N, C)."""
    d = x.shape[-1]
    chol = torch.linalg.cholesky(covs)                       # (C, D, D)
    diff = x[None] - means[:, None]                          # (C, N, D)
    z = torch.linalg.solve_triangular(chol, diff.transpose(1, 2),
                                      upper=False)           # (C, D, N)
    quad = torch.sum(z * z, dim=1)                           # (C, N)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=1, dim2=2)),
                             dim=-1)                         # (C,)
    return (-0.5 * (d * _LOG2PI + logdet[:, None] + quad)).T


def gmm_log_resp(params: GMMParams, x):
    """(N, C) unnormalised log responsibilities."""
    lp = _chol_log_prob(x, params.means, params.covs)
    return lp + torch.log(torch.clamp_min(params.weights, 1e-30))


def gmm_predict_proba(params: GMMParams, x):
    return torch.softmax(gmm_log_resp(params, x), dim=-1)
