"""Label-map algebra, relabelling, boundaries and contours (port of
``pyimsegm_tpu.labeling``), on the host in numpy and scipy: a label map
comes back from the card once per image.  Every function takes a numpy
array or a tensor."""

import numpy as np
from scipy import ndimage

from pyimsegm_tpu_torch.utils import ImageDimensionError
from pyimsegm_tpu_torch.utils.device import host_array
from pyimsegm_tpu_torch.utils.metrics import contingency_table


def histogram_regions_labels_counts(slic, segm):
    """Overlap counts between superpixels and an annotation;
    (max_slic + 1, max_label + 1)."""
    slic, segm = host_array(slic), host_array(segm)
    if slic.shape != segm.shape:
        raise ImageDimensionError('dimension does not agree')
    if (segm < 0).any():
        raise ValueError('only positive labels are allowed')
    return contingency_table(slic, segm, int(np.max(slic)) + 1,
                             int(segm.max()) + 1).astype(np.float32)


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
    seg1 = host_array(seg1)
    seg2 = host_array(seg2)
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
    seg_ref = host_array(seg_ref)
    seg_relabel = host_array(seg_relabel)
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


def segm_labels_assignment(segm, segm_gt):
    """{region label: list of the ground-truth labels of its pixels}."""
    segm, segm_gt = host_array(segm), host_array(segm_gt)
    if segm_gt.shape != segm.shape:
        raise ImageDimensionError('segm %r and annot %r should match'
                                  % (segm.shape, segm_gt.shape))
    return {int(lb): segm_gt[segm == lb].tolist() for lb in np.unique(segm)}


def assign_label_by_threshold(dict_label_hist, thresh=0.75):
    """LUT of each region's majority label where its share exceeds
    ``thresh``; impure regions get -1."""
    lut = np.zeros(max(dict_label_hist.keys()) + 1, dtype=int) - 1
    for k, v in dict_label_hist.items():
        counts = np.bincount(v) / float(len(v))
        if counts.max() > thresh:
            lut[k] = int(np.argmax(counts))
    return lut


def assign_label_by_max(label_hist):
    """LUT of each region's majority label."""
    lut = np.zeros(max(label_hist.keys()) + 1, dtype=int) - 1
    for k, v in label_hist.items():
        lut[k] = int(np.argmax(np.bincount(v)))
    return lut


def convert_segms_2_list(segms):
    """All segmentations flattened into one list."""
    return np.concatenate([host_array(s).ravel() for s in segms]).tolist()


def mask_segm_labels(img_labeling, labels, mask_init=None):
    """Boolean mask of the pixels of any of ``labels``."""
    img_labeling = host_array(img_labeling)
    mask = (np.zeros(img_labeling.shape, dtype=bool)
            if mask_init is None else mask_init.copy())
    for lb in labels:
        mask |= img_labeling == lb
    return mask


def relabel_by_dict(labels, dict_labels):
    """Relabel by a {new: [old, ...]} map; labels it misses become 0."""
    if not dict_labels:
        raise ValueError('"dict_labels" is required')
    labels = host_array(labels)
    out = np.zeros_like(labels)
    for lb_new, lbs_old in dict_labels.items():
        for lb_old in lbs_old:
            out[labels == lb_old] = lb_new
    return out


def merge_probab_labeling_2d(proba, dict_labels):
    """(H, W, max new + 1) probabilities, each the sum of its old
    channels."""
    proba = host_array(proba)
    if proba.ndim != 3:
        raise ValueError('expected (H, W, C) probabilities')
    if not dict_labels:
        raise ValueError('"dict_labels" is required')
    out = np.zeros(proba.shape[:2] + (max(dict_labels) + 1,))
    for lb_new, lbs_old in dict_labels.items():
        out[:, :, lb_new] = proba[:, :, lbs_old].sum(axis=-1)
    return out


def relabel_max_overlap_merge(seg_ref, seg_relabel, keep_bg=False):
    """Rename every ``seg_relabel`` label to the reference label it overlaps
    most, many to one; a label that overlaps nothing keeps its id, with
    ``keep_bg`` background stays 0 and no other label takes it."""
    seg_ref = host_array(seg_ref)
    seg_relabel = host_array(seg_relabel)
    if seg_ref.shape != seg_relabel.shape:
        raise ImageDimensionError(
            'segmentation shapes differ: reference %r, input %r'
            % (seg_ref.shape, seg_relabel.shape))
    overlap = compute_labels_overlap_matrix(seg_ref, seg_relabel)
    if keep_bg:
        lut = np.concatenate([[0], overlap[1:, 1:].argmax(axis=0) + 1])
    else:
        lut = overlap.argmax(axis=0)
    untouched = overlap.sum(axis=0) == 0
    lut = np.where(untouched, np.arange(lut.size), lut)
    seg_new = lut[seg_relabel]
    return np.where(seg_relabel < 0, seg_relabel, seg_new)


def find_boundaries(segm):
    """'thick' boundaries: pixels with a conn4 neighbour of another label
    (``skimage.segmentation.find_boundaries(mode='thick')``)."""
    segm = host_array(segm)
    b = np.zeros(segm.shape, dtype=bool)
    b[:-1, :] |= segm[:-1, :] != segm[1:, :]
    b[1:, :] |= segm[1:, :] != segm[:-1, :]
    b[:, :-1] |= segm[:, :-1] != segm[:, 1:]
    b[:, 1:] |= segm[:, 1:] != segm[:, :-1]
    return b


def compute_boundary_distances(segm_ref, segm):
    """(reference boundary points (P, 2), their Euclidean distances to the
    nearest boundary of ``segm`` (P,))."""
    segm_ref, segm = host_array(segm_ref), host_array(segm)
    if segm_ref.shape != segm.shape:
        raise ImageDimensionError('Ref. segm %r and segm %r should match'
                                  % (segm_ref.shape, segm.shape))
    ref_b = find_boundaries(segm_ref)
    dist_map = ndimage.distance_transform_edt(~find_boundaries(segm))
    return np.argwhere(ref_b), dist_map[ref_b].ravel()


def get_image2d_boundary_color(segm, size=1):
    """The most frequent label on the ring of ``size`` pixels along the
    image border (the smallest label on a tie)."""
    segm = host_array(segm)
    ring = np.concatenate([
        segm[:size, :].ravel(), segm[-size:, :].ravel(),
        segm[:, :size].ravel(), segm[:, -size:].ravel()])
    vals, cnt = np.unique(ring, return_counts=True)
    return int(vals[np.argmax(cnt)])


def assume_bg_on_boundary(segm, bg_label=0, boundary_size=1):
    """Swap labels so that the dominant border label becomes
    ``bg_label``."""
    segm = host_array(segm)
    boundary_lb = get_image2d_boundary_color(segm, size=boundary_size)
    used = np.unique(segm)
    if boundary_lb not in used:
        segm = segm.copy()
        segm[segm == boundary_lb] = bg_label
    else:
        lut = list(range(int(used.max()) + 1))
        lut[boundary_lb] = bg_label
        lut[bg_label] = boundary_lb
        segm = np.array(lut)[segm]
    return segm


# ----------------------------------------------------- contours & distance ---

def neighbour_connect4(seg, label, pos):
    """True when any conn4 neighbour of ``pos`` differs from ``label``.

    >>> neighbour_connect4(np.eye(5), 1, (2, 2))
    True
    >>> neighbour_connect4(np.ones((5, 5)), 1, (3, 3))
    False
    """
    seg = host_array(seg)
    return any(seg[pos[0] + a, pos[1] + b] != label
               for a, b in [(-1, 0), (0, -1), (1, 0), (0, 1)])


def _contour_mask(seg, label=1, include_boundary=False):
    """conn4 inner-contour mask of one label; the image's first and last
    rows and columns only with ``include_boundary``."""
    seg = host_array(seg)
    is_lb = seg == label
    res = is_lb & find_boundaries(seg)
    res[0, :] = res[-1, :] = res[:, 0] = res[:, -1] = False
    if include_boundary:
        res[0, :] |= is_lb[0, :]
        res[-1, :] |= is_lb[-1, :]
        res[:, 0] |= is_lb[:, 0]
        res[:, -1] |= is_lb[:, -1]
    return res


def contour_binary_map(seg, label=1, include_boundary=False):
    """0/1 inner-contour image of one label.

    >>> img = np.zeros((6, 6), dtype=int)
    >>> img[1:5, 2:] = 1
    >>> contour_binary_map(img)
    array([[0, 0, 0, 0, 0, 0],
           [0, 0, 1, 1, 1, 0],
           [0, 0, 1, 0, 0, 0],
           [0, 0, 1, 0, 0, 0],
           [0, 0, 1, 1, 1, 0],
           [0, 0, 0, 0, 0, 0]])
    """
    return _contour_mask(seg, label, include_boundary).astype(int)


def contour_coords(seg, label=1, include_boundary=False):
    """Inner-contour pixel coordinates of one label, row-major, then (with
    ``include_boundary``) its pixels on the image's first and last column
    of each row and first and last row of each column.

    >>> img = np.zeros((6, 6), dtype=int)
    >>> img[1:5, 2:] = 1
    >>> contour_coords(img)
    [[1, 2], [1, 3], [1, 4], [2, 2], [3, 2], [4, 2], [4, 3], [4, 4]]
    """
    seg = host_array(seg)
    coords = np.argwhere(_contour_mask(seg, label)).tolist()
    if include_boundary:
        w, h = seg.shape[:2]
        for i in range(w):
            if seg[i, 0] == label:
                coords.append([i, 0])
            if seg[i, -1] == label:
                coords.append([i, h - 1])
        for j in range(h):
            if seg[0, j] == label:
                coords.append([0, j])
            if seg[-1, j] == label:
                coords.append([w - 1, j])
    return coords


def binary_image_from_coords(coords, size):
    """0/1 image of ``size`` with the in-bounds ``coords`` set."""
    contour_map = np.zeros(size, dtype=int)
    w, h = size
    for cd in coords:
        if 0 <= cd[0] < w and 0 <= cd[1] < h:
            contour_map[cd[0], cd[1]] = 1
    return contour_map


def compute_distance_map(seg, label=1):
    """Euclidean distance of every pixel to the label's inner contour.

    >>> img = np.zeros((6, 6), dtype=int)
    >>> img[1:5, 2:] = 1
    >>> np.round(compute_distance_map(img)[1], 2).tolist()
    [2.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    """
    return ndimage.distance_transform_edt(1 - contour_binary_map(seg, label))


def sequence_labels_merge(labels_stack, dict_colors, labels_free,
                          change_label=-1):
    """Merge a temporal stack of labelings: a pixel keeps a label that stays
    constant over time (the ``labels_free`` count as any label), else
    ``change_label``.

    >>> dict_colors = {0: [], 1: [], 2: []}
    >>> sequence_labels_merge(np.ones((8, 1, 1)), dict_colors, [0])
    array([[1]])
    >>> sequence_labels_merge(np.array([[1], [0], [1], [1], [1], [1], [0], [0]]), dict_colors, [0])
    array([1])
    """
    labels_stack = np.array(host_array(labels_stack))
    im_labels = np.full(labels_stack.shape[1:], change_label, dtype=int)
    labels_used = [lb for lb in dict_colors if lb not in labels_free]
    lb_all = labels_used + list(labels_free) + [change_label]
    if not all(lb in lb_all for lb in np.unique(labels_stack)):
        raise ValueError('some extra labels in image stack')
    mask_free = mask_segm_labels(labels_stack, labels_free)
    for lb in labels_used:
        mask1 = mask_segm_labels(labels_stack, [lb], mask_free)
        mask2 = mask_segm_labels(labels_stack, [lb])
        mask = np.logical_and(np.all(mask1, axis=0), np.any(mask2, axis=0))
        im_labels[mask] = lb
    return im_labels
