"""Segmentation agreement metrics (port of the ARS part of
``pyimsegm_tpu.utils.metrics``).  Inputs may be numpy arrays or tensors."""

import numpy as np
import torch


def _flat_int(labels):
    if isinstance(labels, torch.Tensor):
        labels = labels.detach().cpu().numpy()
    return np.asarray(labels).ravel().astype(np.int64)


def contingency_table(labels_a, labels_b, num_a, num_b):
    """(num_a, num_b) co-occurrence counts of two flat label vectors."""
    a = _flat_int(labels_a)
    b = _flat_int(labels_b)
    counts = np.bincount(a * num_b + b, minlength=num_a * num_b)
    return counts.reshape(num_a, num_b).astype(np.float64)


def _comb2(x):
    return x * (x - 1.0) / 2.0


def adjusted_rand_score(labels_a, labels_b, num_a=None, num_b=None):
    """Adjusted Rand score of two labelings (sklearn's definition)."""
    la = _flat_int(labels_a)
    lb = _flat_int(labels_b)
    if num_a is None:
        num_a = int(la.max()) + 1
    if num_b is None:
        num_b = int(lb.max()) + 1
    c = contingency_table(la, lb, num_a, num_b)
    n = c.sum()
    sum_comb = _comb2(c).sum()
    a = _comb2(c.sum(axis=1)).sum()
    b = _comb2(c.sum(axis=0)).sum()
    expected = a * b / max(_comb2(n), 1.0)
    denom = 0.5 * (a + b) - expected
    if denom == 0:
        return 1.0
    return float((sum_comb - expected) / denom)
