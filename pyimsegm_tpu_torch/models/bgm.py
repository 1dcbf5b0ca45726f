"""Variational Bayesian Gaussian mixture by coordinate ascent (port of
``pyimsegm_tpu.models.bgm``).

Conjugate mean-field model: a Dirichlet prior on the mixing weights and a
Normal-Wishart prior on each component's mean and precision, with every
update in closed form.  The restarts run as one batch, each seeded by
k-means++ on an explicit ``torch.Generator``, and the fit is exported as
expected parameters (``weights = E[pi]``, ``means = m_k``,
``covs = E[Sigma_k]``) so the predict path is the GMM's.  Where every
restart is NaN, the fit runs again from the same seeds in float64, as
:func:`pyimsegm_tpu_torch.models.gmm.gmm_fit` does.
"""

import torch

from pyimsegm_tpu_torch.models.gmm import (
    GMMParams, _cholesky, _select, _sq_dist, gmm_score,
    kmeans_plus_plus_init)

_LOG2 = 0.6931471805599453
_LOG2PI = 1.8378770664093453


def _cavi_fit_single(generator, x, w, n_classes, max_iter, alpha0, beta0,
                     reg_covar, diag=False, batch=None, centers=None):
    """CAVI runs from k-means++-seeded responsibilities (``batch`` of them
    at once, or one), or from the given (..., C, D) ``centers``.

    With ``diag=True`` the Wishart scale is diagonalised at every update."""
    n, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    nu0 = float(d)
    n_eff = torch.clamp_min(torch.sum(w), 1.0)
    m0 = torch.sum(x * w[:, None], dim=0) / n_eff
    xc = (x - m0) * torch.sqrt(w)[:, None]
    data_cov = xc.T @ xc / n_eff + reg_covar * eye
    if diag:
        data_cov = data_cov * eye
    w0_inv = data_cov * nu0

    if centers is None:
        centers = kmeans_plus_plus_init(generator, x, w, n_classes,
                                        batch=batch)
    resp = torch.nn.functional.one_hot(
        torch.argmin(_sq_dist(x, centers), dim=-1), n_classes).to(x.dtype) \
        * w[:, None]                                          # (..., N, C)

    def m_step(resp):
        nk = torch.sum(resp, dim=-2) + 1e-10                  # (..., C)
        xbar = (resp.transpose(-1, -2) @ x) / nk[..., None]   # (..., C, D)
        diff = x - xbar[..., :, None, :]                      # (..., C, N, D)
        rc = resp.transpose(-1, -2)[..., None]                # (..., C, N, 1)
        s = (diff * rc).transpose(-1, -2) @ diff \
            / torch.clamp_min(torch.sum(resp, dim=-2), 1e-10)[..., None, None]
        alpha = alpha0 + nk
        beta = beta0 + nk
        m = (beta0 * m0 + nk[..., None] * xbar) / beta[..., None]
        dm = xbar - m0
        winv = (w0_inv + nk[..., None, None] * s
                + (beta0 * nk / beta)[..., None, None]
                * dm[..., :, None] * dm[..., None, :])
        if diag:
            winv = winv * eye
        nu = nu0 + nk
        return alpha, beta, m, winv, nu

    def e_step(alpha, beta, m, winv, nu):
        e_logpi = torch.digamma(alpha) \
            - torch.digamma(torch.sum(alpha, dim=-1, keepdim=True))
        i = torch.arange(1, d + 1, dtype=x.dtype, device=x.device)
        chol = _cholesky(winv)                                # (..., C, D, D)
        logdet_winv = 2.0 * torch.sum(torch.log(torch.diagonal(
            chol, dim1=-2, dim2=-1)), dim=-1)                 # (..., C)
        e_logdet = (torch.sum(torch.digamma((nu[..., None] + 1.0 - i) / 2.0),
                              dim=-1) + d * _LOG2 - logdet_winv)
        diff = x - m[..., :, None, :]                         # (..., C, N, D)
        z = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                          upper=False)        # (..., C, D, N)
        quad = nu[..., None] * torch.sum(z * z, dim=-2) \
            + d / beta[..., None]                             # (..., C, N)
        logp = (0.5 * (e_logdet[..., None] - quad)).transpose(-1, -2)
        logr = logp + e_logpi[..., None, :] - 0.5 * d * _LOG2PI
        return torch.softmax(logr, dim=-1) * w[:, None]

    for _ in range(max_iter):
        resp = e_step(*m_step(resp))
    alpha, _beta, m, winv, nu = m_step(resp)
    weights = alpha / torch.sum(alpha, dim=-1, keepdim=True)
    denom = torch.clamp_min(nu - d - 1.0, 1.0)
    covs = winv / denom[..., None, None] + reg_covar * eye
    return GMMParams(weights, m, covs)


def bgm_fit(generator, x, sample_weight, n_classes, n_init=4, max_iter=99,
            alpha0=None, beta0=1.0, reg_covar=1e-6, diag=False):
    """Fit the variational Bayesian GMM: ``n_init`` restarts in one batch,
    the best by weighted log-likelihood (a NaN restart never wins).

    :param x: (N, D) float
    :param sample_weight: (N,) float, 0 = empty slot
    :returns: expected-parameter :class:`GMMParams`
    """
    x = x.to(torch.float32)
    w = sample_weight.to(torch.float32)
    if alpha0 is None:
        alpha0 = 1.0 / n_classes                   # sklearn's default
    centers = kmeans_plus_plus_init(generator, x, w, n_classes, batch=n_init)
    hyper = (n_classes, max_iter, float(alpha0), float(beta0),
             float(reg_covar))
    params = _cavi_fit_single(None, x, w, *hyper, diag=diag, centers=centers)
    scores = gmm_score(params, x, w)
    if bool(torch.isnan(scores).all()):
        x, w = x.double(), w.double()
        params = _cavi_fit_single(None, x, w, *hyper, diag=diag,
                                  centers=centers.double())
        scores = gmm_score(params, x, w)
        params = GMMParams(params.weights.float(), params.means.float(),
                           params.covs)
    return _select(params, scores)
