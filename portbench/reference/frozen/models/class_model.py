"""Class-model pipeline: scaler -> GMM, as an ``nn.Module`` (frozen from
the port's ``models/class_model``).  The fitted arrays are registered
buffers, so ``model.to(device)`` moves them and the predict path runs on
the model's device.  :func:`estim_class_model` fits the 'GMM' option on
the device of its features; :func:`class_model_from_numpy` builds a model
from plain arrays (a run's fitted model, which the reference judges).
"""

import numpy as np
import torch
from torch import nn

from portbench.reference.frozen.models import gmm as gmm_mod

class ClassModel(nn.Module):
    """Fitted scaler + GMM pipeline.

    Buffers: ``scaler_mean``/``scaler_scale`` (D,) and ``weights`` (C,),
    ``means`` (C, D), ``covs`` (C, D, D).  All are float32 but ``covs``
    given in float64 (the GMM's float64 refit), which stays so.
    """

    def __init__(self, weights, means, covs, scaler_mean, scaler_scale):
        super().__init__()
        for name, val in (('scaler_mean', scaler_mean),
                          ('scaler_scale', scaler_scale),
                          ('weights', weights), ('means', means),
                          ('covs', covs)):
            keep64 = name == 'covs' and torch.is_tensor(val) \
                and val.dtype == torch.float64
            self.register_buffer(name, torch.as_tensor(
                val, dtype=torch.float64 if keep64 else torch.float32))

    @property
    def gmm(self):
        return gmm_mod.GMMParams(self.weights, self.means, self.covs)

    def predict_proba(self, features):
        """(N, C) class responsibilities."""
        x = (features.to(torch.float32) - self.scaler_mean) / self.scaler_scale
        return gmm_mod.gmm_predict_proba(self.gmm, x)


def class_model_from_numpy(d):
    """ClassModel from a dict of arrays ``scaler_mean``, ``scaler_scale``,
    ``weights``, ``means`` and ``covs``; float64 ``covs`` (the GMM's float64
    refit) stay float64."""
    covs = np.asarray(d['covs'])
    covs = torch.as_tensor(covs) if covs.dtype == np.float64 \
        else np.array(covs, np.float32)
    return ClassModel(np.array(d['weights'], np.float32),
                      np.array(d['means'], np.float32), covs,
                      np.array(d['scaler_mean'], np.float32),
                      np.array(d['scaler_scale'], np.float32))


def _fit_scaler(x, w):
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(x * w[:, None], dim=0) / n
    var = torch.sum(((x - mean) ** 2) * w[:, None], dim=0) / n
    return mean, torch.sqrt(torch.clamp_min(var, 1e-12))


def estim_class_model(features, nb_classes, estim_model='GMM', max_iter=99,
                      sample_weight=None, seed=0):
    """Fit the scaler + GMM pipeline ('GMM': EM from k-means++ seeds, the
    best of ``sqrt(max_iter)`` restarts).

    :param features: (N, D) tensor, fitted on its device
    :param sample_weight: optional (N,) weights (0 = empty slot)
    :param seed: seed of the ``torch.Generator`` of the fit
    :returns: :class:`ClassModel` on the features' device
    """
    if estim_model != 'GMM':
        raise ValueError('the reference fits estim_model=\'GMM\' only, not %r'
                         % estim_model)
    x = features.to(torch.float32)
    n = x.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=x.device)
         if sample_weight is None else sample_weight.to(torch.float32))
    stages = {}
    stages['scaler_mean'], stages['scaler_scale'] = _fit_scaler(x, w)
    x = (x - stages['scaler_mean']) / stages['scaler_scale']
    gen = torch.Generator(device=x.device).manual_seed(int(seed))
    n_init = max(1, int(np.sqrt(max_iter)))
    params = gmm_mod.gmm_fit(gen, x, w, nb_classes, n_init=n_init,
                             max_iter=max_iter)
    return ClassModel(params.weights, params.means, params.covs, **stages)
