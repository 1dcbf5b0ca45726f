"""Overlap histograms of superpixels against an annotation and the
max-overlap relabelling (port of the part of ``pyimsegm_tpu.labeling`` the
supervised app uses), on the host in numpy: the label maps come back from
the card once per image."""

import numpy as np


class ImageDimensionError(TypeError):
    """Two label maps (or an image and its annotation) of different
    shapes."""


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
        raise ImageDimensionError('dimension does not agree')
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


def compute_labels_overlap_matrix(seg1, seg2):
    """(max seg1 + 1, max seg2 + 1) integer overlap counts of two
    segmentations; negative labels are ignored."""
    seg1 = np.asarray(seg1)
    seg2 = np.asarray(seg2)
    if seg1.shape != seg2.shape:
        raise ImageDimensionError('segm %r and segm %r should match'
                                  % (seg1.shape, seg2.shape))
    sel = (seg1 >= 0) & (seg2 >= 0)
    n1, n2 = int(seg1.max()) + 1, int(seg2.max()) + 1
    return contingency_table(seg1[sel], seg2[sel], n1, n2).astype(int)


def relabel_max_overlap_unique(seg_ref, seg_relabel, keep_bg=False):
    """Rename the labels of ``seg_relabel`` so that each takes the reference
    label it overlaps most, one to one, greedily by descending overlap
    (ties by row-major cell).  A label left without a reference partner
    keeps its own id while that is unclaimed, else takes the smallest
    unclaimed one; negative labels stay."""
    seg_ref = np.asarray(seg_ref)
    seg_relabel = np.asarray(seg_relabel)
    if seg_ref.shape != seg_relabel.shape:
        raise ImageDimensionError(
            'segmentation shapes differ: reference %r, input %r'
            % (seg_ref.shape, seg_relabel.shape))
    overlap = compute_labels_overlap_matrix(seg_ref, seg_relabel)
    n_in = int(seg_relabel.max()) + 1
    lut = np.full(n_in, -1, dtype=int)
    if keep_bg:
        lut[0] = 0
        overlap[0, :] = 0
        overlap[:, 0] = 0
    flat = overlap.ravel()
    ref_free = np.ones(overlap.shape[0], dtype=bool)
    if keep_bg:
        ref_free[0] = False
    for cell in np.lexsort((np.arange(flat.size), -flat)):
        if flat[cell] == 0:
            break
        rr, ee = divmod(cell, overlap.shape[1])
        if ref_free[rr] and ee < n_in and lut[ee] < 0:
            lut[ee] = rr
            ref_free[rr] = False
    claimed = set(lut[lut >= 0].tolist())
    for ee in np.flatnonzero(lut < 0):
        if ee not in claimed:
            lut[ee] = ee
            claimed.add(ee)
    spare = (i for i in range(2 * n_in) if i not in claimed)
    for ee in np.flatnonzero(lut < 0):
        lut[ee] = next(spare)
    seg_new = lut[seg_relabel]
    return np.where(seg_relabel < 0, seg_relabel, seg_new)
