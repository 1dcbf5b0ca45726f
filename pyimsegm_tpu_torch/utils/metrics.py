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


def segment_digest(labels, num_segments):
    """(K, 2) int64 [element count, sum of flat element indices] per label.
    Two labelings of one array give the same row to a label whose element
    set they agree on; a row that differs marks a label they disagree on."""
    flat = _flat_int(labels)
    count = np.bincount(flat, minlength=num_segments)[:num_segments]
    # float64 sums of integers below 2**53 are exact
    index = np.arange(flat.size, dtype=np.float64)
    index_sum = np.bincount(flat, weights=index,
                            minlength=num_segments)[:num_segments]
    return np.stack([count, index_sum.astype(np.int64)], axis=-1)


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
