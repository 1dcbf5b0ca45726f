"""Gaussian-mixture EM and k-means (port of ``pyimsegm_tpu.models.gmm``).

Every function takes optional leading batch dimensions on the fitted
arrays, so the ``n_init`` random restarts of :func:`gmm_fit` run as one
batch (the JAX package ``vmap``s them).  EM runs to ``max_iter`` and
freezes each restart once its mean log-likelihood moves by at most ``tol``:
the same result as the reference's data-dependent stop, with no host
synchronisation inside the loop.  A covariance that is not positive
definite gives NaN (as JAX's ``cholesky`` does), and a NaN restart loses
the selection.  Where every restart breaks down so (nearly collinear
features, whose f32 covariance plus ``reg_covar`` rounds to an indefinite
matrix), the fit runs EM again from the same start in float64 and keeps
those covariances in float64; JAX returns the NaN fit there.  Deciding
this is the fit's one host synchronisation.  While a profiler records
(``utils.device.tracing``), EM counts its runs, iterations and refits, and
the restart-iterations that were still active, read at that same
synchronisation.

Randomness comes from an explicit ``torch.Generator`` on the data's device;
categorical draws use the Gumbel-max trick.  The draws differ from
``jax.random``'s, so random fits agree with the JAX package in likelihood,
not bit for bit.

Samples carry a weight, so empty superpixel slots do not move the fit.
"""

import functools
from typing import NamedTuple

import torch

from pyimsegm_tpu_torch.utils.device import count, tracing

_LOG2PI = 1.8378770664093453


def full_precision(fn):
    """Run the wrapped function with full-f32 matmuls and convolutions: TF32
    off for both and ``float32_matmul_precision('highest')``, the caller's
    settings restored afterwards.  The package already switches TF32 off at
    import; this keeps a fit exact where a caller turned it back on."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision('highest')
        try:
            return fn(*args, **kwargs)
        finally:
            # the precision first: setting it also sets matmul.allow_tf32
            torch.set_float32_matmul_precision(saved[2])
            torch.backends.cuda.matmul.allow_tf32 = saved[0]
            torch.backends.cudnn.allow_tf32 = saved[1]
    return wrapped


class GMMParams(NamedTuple):
    weights: torch.Tensor    # (..., C)
    means: torch.Tensor      # (..., C, D)
    covs: torch.Tensor       # (..., C, D, D)


def _cholesky(mats):
    """Lower Cholesky factors; NaN where a matrix is not positive definite
    (no host check, unlike ``torch.linalg.cholesky``)."""
    chol, info = torch.linalg.cholesky_ex(mats)
    return torch.where((info != 0)[..., None, None], float('nan'), chol)


def _chol_log_prob(x, means, covs):
    """log N(x | mu_c, Sigma_c) for all components: (..., N, C) in x's
    dtype, computed in the covariances' dtype."""
    d = x.shape[-1]
    dt = covs.dtype
    chol = _cholesky(covs)                                   # (..., C, D, D)
    diff = x.to(dt) - means.to(dt)[..., :, None, :]          # (..., C, N, D)
    z = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                      upper=False)           # (..., C, D, N)
    quad = torch.sum(z * z, dim=-2)                          # (..., C, N)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2,
                                                      dim2=-1)), dim=-1)
    return (-0.5 * (d * _LOG2PI + logdet[..., None] + quad)) \
        .transpose(-1, -2).to(x.dtype)


def gmm_log_resp(params: GMMParams, x):
    """(..., N, C) unnormalised log responsibilities."""
    lp = _chol_log_prob(x, params.means, params.covs)
    return lp + torch.log(torch.clamp_min(params.weights, 1e-30))[..., None, :]


def gmm_predict_proba(params: GMMParams, x):
    return torch.softmax(gmm_log_resp(params, x), dim=-1)


def _mean_ll(log_resp, sample_weight):
    ll = torch.logsumexp(log_resp, dim=-1)
    return torch.sum(ll * sample_weight, dim=-1) \
        / torch.clamp_min(torch.sum(sample_weight), 1.0)


def gmm_score(params: GMMParams, x, sample_weight):
    """Weighted mean log-likelihood (the restart-selection criterion)."""
    return _mean_ll(gmm_log_resp(params, x), sample_weight)


def _m_step(x, resp, sample_weight, reg_covar):
    """Weights, means and full covariances from (..., N, C)
    responsibilities."""
    w = resp * sample_weight[:, None]                        # (..., N, C)
    nk = torch.sum(w, dim=-2) + 1e-10                        # (..., C)
    means = (w.transpose(-1, -2) @ x) / nk[..., None]        # (..., C, D)
    diff = x - means[..., :, None, :]                        # (..., C, N, D)
    wt = w.transpose(-1, -2)[..., None]                      # (..., C, N, 1)
    denom = torch.sum(w + 1e-10, dim=-2)                     # (..., C)
    covs = (diff * wt).transpose(-1, -2) @ diff / denom[..., None, None]
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    weights = nk / torch.sum(nk, dim=-1, keepdim=True)
    return GMMParams(weights, means, covs + reg_covar * eye)


# ---------------------------------------------------------------- k-means ---

def _sq_dist(x, centers):
    """(..., N, C) squared distances of (N, D) samples to (..., C, D)
    centres, as explicit differences."""
    diff = x[:, None, :] - centers[..., None, :, :]
    return torch.sum(diff * diff, dim=-1)


def _categorical(generator, logits):
    """One draw per row of (..., N) logits (Gumbel-max)."""
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def kmeans_plus_plus_init(generator, x, sample_weight, n_clusters,
                          batch=None):
    """k-means++ seeding: the first centre drawn by weight, each next one by
    weight times the squared distance to the nearest centre so far.

    :param batch: number of independent seedings, or None for one
    :returns: (C, D) centres, or (batch, C, D)
    """
    shape = () if batch is None else (batch,)
    logw = torch.log(torch.clamp_min(sample_weight, 1e-30))
    idx = _categorical(generator, logw.expand(shape + logw.shape))
    centers = torch.zeros(shape + (n_clusters, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    centers[..., 0, :] = x[idx]
    later = torch.arange(n_clusters, device=x.device)
    for i in range(1, n_clusters):
        pen = torch.where(later < i, 0.0, 1e30)
        d2 = torch.amin(_sq_dist(x, centers) + pen, dim=-1)  # (..., N)
        idx = _categorical(generator,
                           torch.log(torch.clamp_min(d2, 1e-30)) + logw)
        centers[..., i, :] = x[idx]
    return centers


def kmeans_fit(generator, x, sample_weight, n_clusters, n_iter=50,
               init_centers=None, batch=None):
    """Lloyd iterations from k-means++ seeds (or ``init_centers``).

    :returns: (centres (..., C, D), labels (..., N) int64)
    """
    x = x.to(torch.float32)
    if init_centers is None:
        init_centers = kmeans_plus_plus_init(generator, x, sample_weight,
                                             n_clusters, batch=batch)
    centers = init_centers.to(torch.float32)
    for _ in range(n_iter):
        labels = torch.argmin(_sq_dist(x, centers), dim=-1)
        onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype) \
            * sample_weight[:, None]                         # (..., N, C)
        cnt = torch.sum(onehot, dim=-2)                      # (..., C)
        new = (onehot.transpose(-1, -2) @ x) \
            / torch.clamp_min(cnt, 1e-10)[..., None]
        centers = torch.where((cnt > 0)[..., None], new, centers)
    return centers, torch.argmin(_sq_dist(x, centers), dim=-1)


def quantile_init_centers(x, n_clusters):
    """Per-dimension percentiles at ``linspace(5, 95, n_clusters)``
    (linear interpolation, as ``jnp.percentile``): (C, D)."""
    q = torch.linspace(5.0, 95.0, n_clusters, dtype=torch.float32,
                       device=x.device) / 100.0
    return torch.quantile(x.to(torch.float32), q, dim=0)


# -------------------------------------------------------------------- EM ---

def _em_fit(x, sample_weight, max_iter, reg_covar, init_resp, tol=1e-3):
    """EM from (..., N, C) responsibilities ``init_resp``, stopped per
    restart once the weighted mean log-likelihood moves by at most ``tol``.
    While tracing it counts ``em_runs``, ``em_iters`` and
    ``em_restart_iters``, and sums each iteration's active restarts on the
    device (one elementwise add an iteration).

    :returns: (params with the leading dimensions of ``init_resp``, scores,
        the (...) iterations each restart was active, or None untraced)
    """
    params = _m_step(x, init_resp, sample_weight, reg_covar)
    shape = params.weights.shape[:-1]
    prev_ll = torch.full(shape, float('-inf'), dtype=x.dtype,
                         device=x.device)
    ll = torch.full(shape, float('inf'), dtype=x.dtype, device=x.device)
    active_iters = torch.zeros(shape, dtype=torch.int32, device=x.device) \
        if tracing() else None
    for _ in range(max_iter):
        active = torch.abs(ll - prev_ll) > tol     # NaN stops, as in JAX
        if active_iters is not None:
            active_iters += active
        lr = gmm_log_resp(params, x)
        new = _m_step(x, torch.softmax(lr, dim=-1), sample_weight, reg_covar)
        new_ll = _mean_ll(lr, sample_weight)
        params = GMMParams(*[
            torch.where(active.reshape(shape + (1,) * (a.ndim - len(shape))),
                        a, b) for a, b in zip(new, params)])
        prev_ll = torch.where(active, ll, prev_ll)
        ll = torch.where(active, new_ll, ll)
    if active_iters is not None:
        count('em_runs')
        count('em_iters', max_iter)
        count('em_restart_iters', max_iter * shape.numel())
    return params, gmm_score(params, x, sample_weight), active_iters


def _em_fit_f64_if_all_nan(x, sample_weight, max_iter, reg_covar, init_resp):
    """:func:`_em_fit` in float32; where every restart's score is NaN, again
    in float64 from the same responsibilities (weights and means returned
    in float32, covariances in float64).  While tracing, the active
    restart-iterations come to the host in the same copy as the NaN test
    (``em_active_iters``; a refit's take one copy more), and a refit counts
    ``em_refits``."""
    params, scores, active = _em_fit(x, sample_weight, max_iter, reg_covar,
                                     init_resp)
    if active is None:
        all_nan = bool(torch.isnan(scores).all())
    else:
        all_nan, n_active = torch.stack([
            torch.isnan(scores).all().to(torch.int64), active.sum()]).tolist()
        count('em_active_iters', n_active)
    if all_nan:
        count('em_refits')
        params, scores, active = _em_fit(x.double(), sample_weight.double(),
                                         max_iter, reg_covar,
                                         init_resp.double())
        if active is not None:
            count('em_active_iters', int(active.sum()))
        params = GMMParams(params.weights.float(), params.means.float(),
                           params.covs)
    return params, scores


def _select(params, scores):
    """The restart with the best score; a NaN score never wins."""
    scores = torch.where(torch.isnan(scores), float('-inf'), scores)
    best = torch.argmax(scores)
    return GMMParams(*[a[best] for a in params])


def gmm_fit(generator, x, sample_weight, n_components, n_init=1, max_iter=99,
            reg_covar=1e-6):
    """Full-covariance GMM, ``n_init`` restarts in one batch.

    :param x: (N, D) features
    :param sample_weight: (N,) float; 0 disables a sample
    :returns: the best :class:`GMMParams` by weighted log-likelihood
    """
    x = x.to(torch.float32)
    _, labels = kmeans_fit(generator, x, sample_weight, n_components,
                           n_iter=15, batch=n_init)
    resp = torch.nn.functional.one_hot(labels, n_components).to(x.dtype)
    return _select(*_em_fit_f64_if_all_nan(x, sample_weight, max_iter,
                                           reg_covar, resp))


def gmm_fit_from_labels(x, labels, sample_weight, n_components, max_iter=1,
                        reg_covar=1e-6):
    """EM seeded from hard labels (the 'GMM_kmeans' / 'GMM_Otsu' / 'kmeans'
    options)."""
    x = x.to(torch.float32)
    resp = torch.nn.functional.one_hot(labels.to(torch.int64),
                                       n_components).to(x.dtype)
    return _em_fit_f64_if_all_nan(x, sample_weight, max_iter, reg_covar,
                                  resp)[0]
