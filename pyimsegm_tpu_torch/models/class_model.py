"""Class-model pipeline: scaler -> PCA -> mixture model, as an
``nn.Module`` (port of ``pyimsegm_tpu.models.class_model``).

The fitted arrays are registered buffers, so ``model.to(device)`` moves
them and the predict path runs on the model's device.
:func:`estim_class_model` fits one on the device of its features, with the
reference's options 'GMM', 'GMM_kmeans', 'GMM_Otsu', 'kmeans',
'kmeans_quantiles', 'BGM' and 'Otsu' (EM seeded from the clustering labels,
which the option names describe).  :func:`class_model_from_numpy` builds a
model from plain arrays, which is how a model fitted by the JAX package is
carried over.  PCA keeps shapes static: the full rotation is applied and
the components beyond the requested explained-variance mass are masked to
zero.
"""

import numpy as np
import torch
from torch import nn

from pyimsegm_tpu_torch.models import gmm as gmm_mod
from pyimsegm_tpu_torch.models import otsu as otsu_mod
from pyimsegm_tpu_torch.utils.device import as_tensor

_OPTIONAL = ('scaler_mean', 'scaler_scale', 'pca_components', 'pca_mean',
             'pca_mask')


class ClassModel(nn.Module):
    """Fitted scaler + PCA + GMM pipeline.

    Buffers: ``scaler_mean``/``scaler_scale`` (D,), ``pca_components``
    (D, D) rows = principal axes, ``pca_mean`` (D,), ``pca_mask`` (D,) —
    each may be None — and ``weights`` (C,), ``means`` (C, D), ``covs``
    (C, D, D).
    """

    def __init__(self, weights, means, covs, scaler_mean=None,
                 scaler_scale=None, pca_components=None, pca_mean=None,
                 pca_mask=None):
        super().__init__()
        for name, val in (('scaler_mean', scaler_mean),
                          ('scaler_scale', scaler_scale),
                          ('pca_components', pca_components),
                          ('pca_mean', pca_mean), ('pca_mask', pca_mask),
                          ('weights', weights), ('means', means),
                          ('covs', covs)):
            self.register_buffer(
                name, None if val is None else torch.as_tensor(
                    val, dtype=torch.float32))

    @property
    def gmm(self):
        return gmm_mod.GMMParams(self.weights, self.means, self.covs)

    @property
    def n_classes(self):
        return self.weights.shape[0]

    def transform(self, features):
        x = features.to(torch.float32)
        if self.scaler_mean is not None:
            x = (x - self.scaler_mean) / self.scaler_scale
        if self.pca_components is not None:
            x = ((x - self.pca_mean) @ self.pca_components.T) * self.pca_mask
        return x

    def predict_proba(self, features):
        """(N, C) class responsibilities."""
        return gmm_mod.gmm_predict_proba(self.gmm, self.transform(features))

    def predict(self, features):
        return torch.argmax(self.predict_proba(features),
                            dim=-1).to(torch.int32)


def class_model_from_numpy(d):
    """ClassModel from a dict of arrays: ``weights``, ``means``, ``covs`` and
    the optional ``scaler_mean``, ``scaler_scale``, ``pca_components``,
    ``pca_mean``, ``pca_mask`` (missing or None = stage off)."""
    opt = {k: (None if d.get(k) is None else np.array(d[k], np.float32))
           for k in _OPTIONAL}
    return ClassModel(np.array(d['weights'], np.float32),
                      np.array(d['means'], np.float32),
                      np.array(d['covs'], np.float32), **opt)


def _fit_scaler(x, w):
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    var = torch.sum(((x - mean) ** 2) * w[:, None], dim=0) / n
    return mean, torch.sqrt(torch.clamp_min(var, 1e-12))


def _fit_pca(x, w, pca_coef):
    """(components (D, D) rows = axes by falling variance, mean (D,), mask
    (D,) of the minimal leading set explaining >= ``pca_coef``)."""
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    xc = (x - mean) * torch.sqrt(w)[:, None]
    eigval, eigvec = torch.linalg.eigh(xc.T @ xc / n)
    order = torch.argsort(-eigval, stable=True)
    eigval = eigval[order]
    eigvec = eigvec[:, order]
    ratio = torch.cumsum(eigval, 0) / torch.clamp_min(torch.sum(eigval), 1e-30)
    keep = torch.cat([torch.ones(1, device=x.device),
                      (ratio[:-1] < pca_coef).to(torch.float32)])
    return eigvec.T, mean, keep


def estim_class_model(features, nb_classes, estim_model='GMM', pca_coef=None,
                      use_scaler=True, max_iter=99, sample_weight=None, seed=0,
                      device='cuda'):
    """Fit the scaler + PCA + model pipeline.

    :param features: (N, D) tensor (fitted on its device) or array (fitted
        on ``device``)
    :param sample_weight: optional (N,) weights (0 = empty slot)
    :param seed: seed of the ``torch.Generator`` of the random fits
    :returns: :class:`ClassModel` on the features' device
    """
    x = as_tensor(features, device).to(torch.float32)
    n = x.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=x.device)
         if sample_weight is None
         else as_tensor(sample_weight, x.device).to(torch.float32))
    stages = {}
    if use_scaler:
        stages['scaler_mean'], stages['scaler_scale'] = _fit_scaler(x, w)
        x = (x - stages['scaler_mean']) / stages['scaler_scale']
    if pca_coef is not None:
        comps, mean, mask = _fit_pca(x, w, float(pca_coef))
        stages.update(pca_components=comps, pca_mean=mean, pca_mask=mask)
        x = ((x - mean) @ comps.T) * mask

    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    n_init = max(1, int(np.sqrt(max_iter)))
    base, _, init_type = estim_model.partition('_')
    if base == 'GMM' and not init_type:
        params = gmm_mod.gmm_fit(gen, x, w, nb_classes, n_init=n_init,
                                 max_iter=max_iter)
    elif base == 'GMM' and init_type == 'kmeans':
        _, y = gmm_mod.kmeans_fit(gen, x, w, nb_classes, n_iter=max_iter)
        params = gmm_mod.gmm_fit_from_labels(x, y, w, nb_classes,
                                             max_iter=max_iter)
    elif base == 'GMM' and init_type == 'Otsu':
        y = otsu_mod.compute_multivariate_otsu(x, w)
        params = gmm_mod.gmm_fit_from_labels(x, y, w, nb_classes,
                                             max_iter=max_iter)
    elif base == 'kmeans':
        if init_type == 'quantiles':
            centers = gmm_mod.quantile_init_centers(x, nb_classes)
            _, y = gmm_mod.kmeans_fit(gen, x, w, nb_classes, n_iter=2,
                                      init_centers=centers)
        else:
            _, y = gmm_mod.kmeans_fit(gen, x, w, nb_classes, n_iter=max_iter)
        params = gmm_mod.gmm_fit_from_labels(x, y, w, nb_classes, max_iter=1)
    elif base == 'BGM':
        from pyimsegm_tpu_torch.models import bgm as bgm_mod
        params = bgm_mod.bgm_fit(gen, x, w, nb_classes, n_init=n_init,
                                 max_iter=max_iter)
    elif base == 'Otsu':
        if nb_classes != 2:
            raise ValueError("estim_model='Otsu' supports exactly 2 classes")
        y = otsu_mod.compute_multivariate_otsu(x, w)
        params = gmm_mod.gmm_fit_from_labels(x, y, w, nb_classes, max_iter=1)
    else:
        raise ValueError('unknown estim_model: %r' % estim_model)
    return ClassModel(params.weights, params.means, params.covs, **stages)
