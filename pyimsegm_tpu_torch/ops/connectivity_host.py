"""skimage's connectivity postprocess of SLIC labels on the host (numpy +
``scipy.ndimage``), a copy of the numpy twin of the JAX package's native
union-find (``pyimsegm_tpu.native``): every output label is one
conn4-connected component, relabelled sequentially in raster order of its
first pixel, and a component below ``min_size`` merges into the adjacent
already-relabelled component it touches most.

The output label count depends on the data, so this stays on the host; the
compat SLIC mode (``ops/slic.py``) runs it after its device iterations.
"""

import numpy as np


def enforce_connectivity(labels, min_size=16):
    """Relabel so every output label is one conn4-connected component and
    merge fragments smaller than ``min_size`` into a neighbour (contact =
    distinct adjacent cells, ties to the smallest output label).

    Each input label is split within its bounding box, which labels the
    components as a pass over the whole image would.

    :param labels: (H, W) integer labels >= 0
    :returns: (H, W) int32 labels
    """
    from scipy import ndimage
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = labels.shape
    comp = np.full((h, w), -1, np.int64)
    nxt = 0
    sizes, first_px, bboxes = [], [], []
    for lb0, box in enumerate(ndimage.find_objects(labels + 1)):
        if box is None:
            continue
        cc, _n = ndimage.label(labels[box] == lb0)
        for ci, sub_sl in enumerate(ndimage.find_objects(cc), start=1):
            sl = tuple(slice(b.start + s.start, b.start + s.stop)
                       for b, s in zip(box, sub_sl))
            sub = cc[sub_sl] == ci
            comp[sl][sub] = nxt
            sizes.append(int(sub.sum()))
            ys, xs = np.nonzero(sub)
            o = np.lexsort((xs, ys))[0]
            first_px.append((sl[0].start + int(ys[o]),
                             sl[1].start + int(xs[o])))
            bboxes.append(sl)
            nxt += 1
    sizes = np.asarray(sizes)

    order = np.argsort([fy * w + fx for fy, fx in first_px], kind='stable')
    remap = np.full(nxt, -1, np.int64)
    out_next = 0
    for comp_id in order:
        if sizes[comp_id] >= min_size or out_next == 0:
            remap[comp_id] = out_next
            out_next += 1
            continue
        sl = bboxes[comp_id]
        gsl = (slice(max(sl[0].start - 1, 0), min(sl[0].stop + 1, h)),
               slice(max(sl[1].start - 1, 0), min(sl[1].stop + 1, w)))
        win = comp[gsl]
        sel = win == comp_id
        nb = np.zeros_like(sel)
        nb[:-1] |= sel[1:]
        nb[1:] |= sel[:-1]
        nb[:, :-1] |= sel[:, 1:]
        nb[:, 1:] |= sel[:, :-1]
        nb &= ~sel
        nb_out = remap[np.maximum(win[nb], 0)]
        nb_out = nb_out[(win[nb] >= 0) & (nb_out >= 0)]
        if len(nb_out):
            vals, counts = np.unique(nb_out, return_counts=True)
            remap[comp_id] = vals[np.argmax(counts)]
        else:
            remap[comp_id] = out_next
            out_next += 1
    return remap[comp].astype(np.int32)
