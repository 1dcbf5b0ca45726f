"""Class-model pipeline: scaler -> PCA -> Gaussian mixture, as an
``nn.Module`` (port of ``pyimsegm_tpu.models.class_model.ClassModel``).

The fitted arrays are registered buffers, so ``model.to(device)`` moves
them and the predict path runs on the model's device.
:func:`class_model_from_numpy` builds a model from plain arrays, which is
how a model fitted by the JAX package is carried over.
"""

import numpy as np
import torch
from torch import nn

from pyimsegm_tpu_torch.models import gmm as gmm_mod

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
