"""Overlap histograms of superpixels against an annotation (port of the
part of ``pyimsegm_tpu.labeling`` the supervised training uses), on the
host in numpy: the label maps come back from the card once per image."""

import numpy as np


def contingency_table(labels_a, labels_b, num_a, num_b):
    """(num_a, num_b) f32 co-occurrence counts of two label maps (exact
    integers below 2**24)."""
    a = np.asarray(labels_a).ravel().astype(np.int64)
    b = np.asarray(labels_b).ravel().astype(np.int64)
    counts = np.bincount(a * num_b + b, minlength=num_a * num_b)
    return counts.reshape(num_a, num_b).astype(np.float32)


def histogram_regions_labels_counts(slic, segm):
    """Overlap counts between superpixels and an annotation;
    (max_slic + 1, max_label + 1)."""
    slic, segm = np.asarray(slic), np.asarray(segm)
    if slic.shape != segm.shape:
        raise ValueError('dimension does not agree')
    if (segm < 0).any():
        raise ValueError('only positive labels are allowed')
    return contingency_table(slic, segm, int(np.max(slic)) + 1,
                             int(segm.max()) + 1)


def histogram_regions_labels_norm(slic, segm, nb_labels=None):
    """Row-normalised overlap histogram; empty superpixels give zero
    rows."""
    hist = histogram_regions_labels_counts(slic, segm)
    if nb_labels is not None and hist.shape[1] < nb_labels:
        hist = np.pad(hist, [(0, 0), (0, nb_labels - hist.shape[1])])
    sums = hist.sum(axis=1, keepdims=True)
    sums[sums == 0] = -1.0
    out = hist / sums
    out[out < 0] = 0.0
    return out
