"""Visualisation and small geometry (port of ``pyimsegm_tpu.utils.drawing``).

Two kinds of functions live here.  The array functions (ellipse and
polygon coordinates, the egg-annotation masks, image overlaps, the label
and unary-cost colourings) are numpy only and run wherever the port runs.
The figure functions (``figure_*``, ``draw_image_*``, ``draw_rg2sp_results``,
``draw_image_clusters_centers``, ``draw_graphcut_weighted_edges``) import
matplotlib (Agg backend) when they are called, and raise ``ImportError``
naming matplotlib where it is not installed.

Two pieces of matplotlib are carried as numpy so that the array functions
need none of it: the even-odd crossing rule of ``Path.contains_points`` for
:func:`polygon_fill_coords`, and the 256-entry ``jet`` and ``Greens``
colormap tables with ``Colormap.__call__``'s quantisation for
:func:`draw_color_labeling` and :func:`draw_graphcut_unary_cost_segments`.
Tensors are accepted anywhere an array is and are copied to the host.
"""

import logging

import numpy as np

from pyimsegm_tpu_torch.ellipse_fitting import (  # noqa: F401  (re-export)
    ellipse_fill_coords,
    ellipse_perimeter_coords,
)
from pyimsegm_tpu_torch.utils.device import host_array

#: max figure size in the larger dimension
SIZE_CHESS_FIELD = 50
#: egg annotation landmark columns
COLUMNS_POSITION_EGG_ANNOT = ('ant_x', 'ant_y', 'lat_x', 'lat_y',
                              'post_x', 'post_y')

#: entries of a colormap table (matplotlib's ``image.lut``)
_LUT_SIZE = 256
#: matplotlib's segment data of ``jet`` (x, y0, y1 per channel)
_JET_DATA = {
    'red': ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    'green': ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    'blue': ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}
#: matplotlib's nine ``Greens`` colours (ColorBrewer), evenly spaced
_GREENS_COLORS = (
    (0.9686274509803922, 0.9882352941176471, 0.9607843137254902),
    (0.8980392156862745, 0.9607843137254902, 0.8784313725490196),
    (0.7803921568627451, 0.9137254901960784, 0.7529411764705882),
    (0.6313725490196078, 0.8509803921568627, 0.6078431372549019),
    (0.4549019607843137, 0.7686274509803922, 0.4627450980392157),
    (0.2549019607843137, 0.6705882352941176, 0.36470588235294116),
    (0.13725490196078433, 0.5450980392156862, 0.27058823529411763),
    (0.0, 0.42745098039215684, 0.17254901960784313),
    (0.0, 0.26666666666666666, 0.10588235294117647),
)


def _pyplot(caller):
    """matplotlib's pyplot on the Agg backend, or ``ImportError`` naming
    matplotlib and the figure function that needs it."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError('%s draws a figure with matplotlib, which is not '
                          'installed' % caller) from err
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


# ---------------------------------------------------------------- geometry ---

def ellipse(r, c, r_radius, c_radius, orientation=0., shape=None):
    """Interior coordinates of a rotated ellipse (orientation measured from
    the row axis)."""
    return ellipse_fill_coords(r, c, r_radius, c_radius, orientation,
                               shape=shape)


def ellipse_perimeter(r, c, r_radius, c_radius, orientation=0., shape=None):
    """Perimeter coordinates of a rotated ellipse."""
    return ellipse_perimeter_coords(r, c, r_radius, c_radius, orientation,
                                    shape=shape)


def _points_in_polygon(px, py, vx, vy):
    """matplotlib's ``point_in_path_impl`` for one closed polygon: a point
    is inside when a +x ray from it crosses the edges an odd number of
    times, an edge counting where its end points lie on either side of
    ``y >= py`` and the crossing test (evaluated without a division, as
    matplotlib does) agrees with the upper end's side.  Points on an edge
    fall inside or outside by that rule alone, not symmetrically."""
    inside = np.zeros(px.shape, bool)
    if len(vx) < 3:
        return inside
    xs = np.append(vx, vx[0])
    ys = np.append(vy, vy[0])
    yflag0 = ys[0] >= py
    for k in range(len(vx)):
        x0, y0, x1, y1 = xs[k], ys[k], xs[k + 1], ys[k + 1]
        yflag1 = y1 >= py
        hit = ((y1 - py) * (x0 - x1) >= (x1 - px) * (y0 - y1)) == yflag1
        inside ^= (yflag0 != yflag1) & hit
        yflag0 = yflag1
    return inside


def polygon_fill_coords(rows, cols, shape):
    """Interior (rr, cc) of a polygon by matplotlib's path containment
    rule."""
    rows = np.asarray(host_array(rows), float)
    cols = np.asarray(host_array(cols), float)
    rmin = max(int(np.floor(rows.min())), 0)
    rmax = min(int(np.ceil(rows.max())) + 1, shape[0])
    cmin = max(int(np.floor(cols.min())), 0)
    cmax = min(int(np.ceil(cols.max())) + 1, shape[1])
    if rmax <= rmin or cmax <= cmin:
        return np.zeros(0, int), np.zeros(0, int)
    rr, cc = np.meshgrid(np.arange(rmin, rmax), np.arange(cmin, cmax),
                         indexing='ij')
    pts = np.stack([rr.ravel(), cc.ravel()], axis=1)
    inside = _points_in_polygon(pts[:, 0].astype(float),
                                pts[:, 1].astype(float), rows, cols)
    return pts[inside, 0], pts[inside, 1]


def norm_aplha(alpha):
    """Clamp alpha into [0, 1] (values above 1 read as 0-255)."""
    alpha = alpha / 255. if alpha > 1. else alpha
    return max(0.0, min(1.0, alpha))


def closest_point_on_line(start, end, point):
    """Orthogonal projection of a point onto a line.

    >>> np.round(closest_point_on_line([0, 0], [1, 2], [0, 2]), 2)
    array([0.8, 1.6])
    """
    start, end, point = [np.asarray(host_array(a), float)
                         for a in (start, end, point)]
    d = end - start
    t = np.dot(point - start, d) / max(np.dot(d, d), 1e-12)
    return start + t * d


# ------------------------------------------------------------- egg masks ----

def draw_eggs_ellipse(mask_shape, pos_ant, pos_lat, pos_post,
                      threshold_overlap=0.6):
    """Instance mask from per-egg (anterior, lateral, posterior) landmarks
    fitted as inscribed ellipses; an egg overlapping the drawn ones by more
    than ``threshold_overlap`` is skipped."""
    mask_eggs = np.zeros(mask_shape)
    for i, (ant, lat, post) in enumerate(zip(pos_ant, pos_lat, pos_post)):
        ant, lat, post = map(np.asarray, (ant, lat, post))
        center = ant + (post - ant) / 2.
        lat_proj = closest_point_on_line(ant, post, lat)
        radius_a = np.linalg.norm(post - ant) / 2. / np.sqrt(2)
        radius_b = np.linalg.norm(lat - lat_proj) / np.sqrt(2)
        angle = np.arctan2(*(post - ant))
        rr, cc = ellipse(int(center[1]), int(center[0]), int(radius_a),
                         int(radius_b), orientation=angle, shape=mask_shape)
        mask = np.zeros(mask_shape)
        mask[rr, cc] = True
        m_overlap = np.sum((mask > 0) & (mask_eggs > 0)) \
            / float(max(np.sum(mask), 1))
        if m_overlap > threshold_overlap:
            logging.debug('skip egg drawing while it overlap by %f', m_overlap)
            continue
        mask_eggs[mask.astype(bool)] = i + 1
    return mask_eggs


def parse_annot_rectangles(rows_slice):
    """Landmark table row(s) -> ([(ant)], [(lat)], [(post)]); string cells
    hold space-separated integers in brackets."""
    dict_eggs = {col: rows_slice[col] for col in COLUMNS_POSITION_EGG_ANNOT}
    if all(isinstance(dict_eggs[col], str) for col in dict_eggs):
        dict_eggs = {col: map(int, dict_eggs[col][1:-1].lstrip().split())
                     for col in dict_eggs}
    pos_ant = list(zip(dict_eggs['ant_x'], dict_eggs['ant_y']))
    pos_lat = list(zip(dict_eggs['lat_x'], dict_eggs['lat_y']))
    pos_post = list(zip(dict_eggs['post_x'], dict_eggs['post_y']))
    return pos_ant, pos_lat, pos_post


def draw_eggs_rectangle(mask_shape, pos_ant, pos_lat, pos_post):
    """Per-egg rotated-rectangle masks from the three landmarks."""
    list_masks = []
    for ant, lat, post in zip(list(pos_ant), list(pos_lat), list(pos_post)):
        ant, lat, post = map(np.asarray, (ant, lat, post))
        lat_proj = closest_point_on_line(ant, post, lat)
        shift = lat - lat_proj
        points = np.array([ant + shift, ant - shift, post - shift,
                           post + shift, ant + shift])
        rr, cc = polygon_fill_coords(points[:, 1], points[:, 0], mask_shape)
        mask = np.zeros(mask_shape)
        mask[rr, cc] = True
        list_masks.append(mask)
    return list_masks


def merge_object_masks(masks, overlap_thr=0.7):
    """Merge binary masks into an instance map, skipping a mask whose IoU
    with an instance already drawn exceeds ``overlap_thr``.

    >>> m1 = np.zeros((5, 6), dtype=int); m1[:4, :4] = 1
    >>> m2 = np.zeros((5, 6), dtype=int); m2[2:, 2:] = 1
    >>> int(merge_object_masks([m1, m2])[4, 5])
    2
    """
    if not len(masks):
        raise ValueError('no masks are given')
    inst = np.array(host_array(masks[0]), dtype=int)
    for cand in masks[1:]:
        cand = host_array(cand) == 1
        n_obj = int(inst.max())
        planes = inst[None] == np.arange(1, n_obj + 1)[:, None, None]
        inter = (planes & cand).sum(axis=(1, 2))
        union = (planes | cand).sum(axis=(1, 2))
        iou = inter / np.maximum(union, 1)
        if not (iou > overlap_thr).any():
            inst[cand] = n_obj + 1
    return inst


# --------------------------------------------------------------- overlays ---

def make_overlap_images_optical(images):
    """Mean-blend a list of equally-shaped images."""
    imgs = np.asarray([np.asarray(host_array(im), float) for im in images])
    return np.mean(imgs, axis=0)


def make_overlap_images_chess(images, chess_field=SIZE_CHESS_FIELD):
    """Chessboard-interleave a list of images."""
    imgs = [host_array(im) for im in images]
    shape = imgs[0].shape
    rows, cols = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                             indexing='ij')
    sel = ((rows // chess_field) + (cols // chess_field)) % len(imgs)
    out = np.zeros_like(imgs[0])
    for i, im in enumerate(imgs):
        out[sel == i] = im[sel == i]
    return out


def _segment_lut(segments, n=_LUT_SIZE):
    """One channel of a ``LinearSegmentedColormap`` table: matplotlib's
    ``_create_lookup_table`` at gamma 1."""
    adata = np.array(segments, float)
    x = adata[:, 0] * (n - 1)
    y0 = adata[:, 1]
    y1 = adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _colormap_table(name):
    """(N, 4) RGBA table of ``jet`` or ``Greens`` as matplotlib builds it
    (``Greens`` is ``from_list`` of its nine colours)."""
    if name == 'jet':
        data = _JET_DATA
    else:
        vals = np.linspace(0, 1, len(_GREENS_COLORS))
        rgb = np.asarray(_GREENS_COLORS, float)
        data = {ch: np.column_stack([vals, rgb[:, i], rgb[:, i]])
                for i, ch in enumerate(('red', 'green', 'blue'))}
    lut = np.ones((_LUT_SIZE, 4))
    for i, ch in enumerate(('red', 'green', 'blue')):
        lut[:, i] = _segment_lut(data[ch])
    return lut


def _apply_colormap(name, values):
    """RGBA of ``values`` as ``Colormap.__call__`` quantises them: floats
    scale by N with N itself mapped to N - 1, then truncate; below 0 takes
    the first entry, N and above the last, NaN transparent black."""
    lut = _colormap_table(name)
    n = lut.shape[0]
    xa = np.array(values, copy=True)
    if xa.dtype.kind == 'f':
        xa *= n
        xa[xa == n] = n - 1
    under = xa < 0
    over = xa >= n
    bad = np.isnan(xa)
    with np.errstate(invalid='ignore'):
        idx = xa.astype(int)
    idx[under] = n
    idx[over] = n + 1
    idx[bad] = n + 2
    full = np.vstack([lut, lut[:1], lut[-1:], np.zeros((1, 4))])
    return full.take(idx, axis=0, mode='clip')


def draw_color_labeling(segments, lut_labels):
    """Label map -> RGB through the ``jet`` colormap of its LUT values."""
    seg = host_array(lut_labels)[host_array(segments)]
    mx = max(float(np.max(seg)), 1.0)
    return _apply_colormap('jet', seg / mx)[..., :3]


def draw_graphcut_unary_cost_segments(segments, unary_cost):
    """Per-class unary-cost images through the ``Greens`` colormap."""
    unary_cost = host_array(unary_cost)
    segments = host_array(segments)
    unary = 1.0 - unary_cost / max(np.max(unary_cost), 1e-12)
    return [_apply_colormap('Greens', unary[:, i][segments])[..., :3]
            for i in range(unary.shape[-1])]


# ----------------------------------------------------------------- figures ---

def figure_image_adjustment(fig, img_size):
    """Tight axes covering the image area."""
    ax = fig.gca()
    ax.set(xlim=[0, img_size[1]], ylim=[img_size[0], 0])
    ax.axis('off')
    ax.axes.get_xaxis().set_ticklabels([])
    ax.axes.get_yaxis().set_ticklabels([])
    fig.tight_layout(pad=0)
    return fig


def _prepare_gray(img):
    img = np.asarray(img)
    if img.ndim == 3:
        return img.mean(axis=-1)
    return img


def figure_image_segm_results(img, seg, subfig_size=9, mid_labels_alpha=0.2,
                              mid_image_gray=True):
    """Triptych: image / overlay / segmentation."""
    plt = _pyplot('figure_image_segm_results')
    img = host_array(img)
    seg = host_array(seg)
    fig_size = (subfig_size * 3, subfig_size * img.shape[0] / img.shape[1])
    fig, axarr = plt.subplots(ncols=3, figsize=fig_size)
    axarr[0].set_title('original image')
    axarr[0].imshow(img, cmap=plt.cm.Greys_r if img.ndim == 2 else None)
    axarr[1].set_title('segmentation overlap')
    axarr[1].imshow(_prepare_gray(img) if mid_image_gray else img,
                    cmap=plt.cm.Greys_r)
    axarr[1].imshow(seg, alpha=mid_labels_alpha, cmap=plt.cm.jet)
    axarr[1].contour(seg, levels=np.unique(seg), linewidths=2,
                     cmap=plt.cm.jet)
    axarr[2].set_title('segmentation')
    axarr[2].imshow(seg, cmap=plt.cm.jet)
    for ax in axarr:
        ax.axis('off')
        ax.axes.get_xaxis().set_ticklabels([])
        ax.axes.get_yaxis().set_ticklabels([])
    fig.subplots_adjust(wspace=0.01, hspace=0.01)
    fig.tight_layout()
    return fig


def figure_overlap_annot_segm_image(annot, segm, img=None, subfig_size=9,
                                    drop_labels=None, segm_alpha=0.2):
    """Annotation vs segmentation vs their disagreement."""
    plt = _pyplot('figure_overlap_annot_segm_image')
    annot = host_array(annot)
    segm = host_array(segm)
    nb_cols = 3 if img is None else 4
    fig_size = (subfig_size * nb_cols,
                subfig_size * annot.shape[0] / annot.shape[1])
    fig, axarr = plt.subplots(ncols=nb_cols, figsize=fig_size)
    i = 0
    if img is not None:
        img = host_array(img)
        axarr[i].set_title('image')
        axarr[i].imshow(img, cmap=plt.cm.Greys_r if img.ndim == 2 else None)
        i += 1
    axarr[i].set_title('annotation')
    axarr[i].imshow(annot, alpha=segm_alpha + 0.4, cmap=plt.cm.jet)
    axarr[i + 1].set_title('segmentation')
    axarr[i + 1].imshow(segm, alpha=segm_alpha + 0.4, cmap=plt.cm.jet)
    diff = (annot != segm).astype(int)
    if drop_labels:
        for lb in drop_labels:
            diff[annot == lb] = 0
    axarr[i + 2].set_title('difference annot & segment')
    axarr[i + 2].imshow(diff, cmap=plt.cm.Reds)
    for ax in axarr:
        ax.axis('off')
    fig.subplots_adjust(wspace=0.01, hspace=0.01)
    fig.tight_layout()
    return fig


def figure_segm_graphcut_debug(images, subfig_size=9):
    """GraphCut debug figure from a pipeline's debug dict: image,
    superpixels, their means, graph edges, segmentation and the unary
    costs, each panel where its key is present."""
    plt = _pyplot('figure_segm_graphcut_debug')
    keys = [k for k in ('image', 'slic', 'slic_mean', 'img_graph_edges',
                        'img_graph_segm', 'imgs_unary_cost') if k in images]
    panels = []
    for k in keys:
        val = images[k]
        if k == 'imgs_unary_cost':
            panels.extend([(('unary %i' % i), host_array(im))
                           for i, im in enumerate(val)])
        else:
            panels.append((k, host_array(val)))
    nb = max(len(panels), 1)
    img0 = host_array(images[keys[0]]) if keys else np.zeros((2, 2))
    fig_size = (subfig_size * nb, subfig_size * img0.shape[0]
                / max(img0.shape[1], 1))
    fig, axarr = plt.subplots(ncols=nb, figsize=fig_size, squeeze=False)
    for ax, (name, im) in zip(axarr[0], panels):
        ax.set_title(name)
        ax.imshow(im, cmap=plt.cm.jet if im.ndim == 2 else None)
        ax.axis('off')
    fig.tight_layout()
    return fig


def create_figure_by_image(img_size, subfig_size, nb_subfigs=1, extend=0.):
    """Figure scaled to the image's aspect."""
    plt = _pyplot('create_figure_by_image')
    norm_size = np.array(img_size) / float(np.max(img_size))
    fig_size = norm_size[::-1] * subfig_size * np.array([nb_subfigs, 1])
    fig_size[0] += extend * fig_size[0]
    fig, ax = plt.subplots(figsize=fig_size)
    return fig, ax


def figure_ellipse_fitting(img, seg, ellipses, centers, crits, fig_size=9):
    """Fitted ellipses over the image."""
    plt = _pyplot('figure_ellipse_fitting')
    if not len(ellipses) == len(centers) == len(crits):
        raise ValueError('count of ellipses (%i) and centers (%i) and crits'
                         ' (%i) should match'
                         % (len(ellipses), len(centers), len(crits)))
    img = host_array(img)
    seg = host_array(seg)
    fig, ax = create_figure_by_image(img.shape[:2], fig_size)
    ax.imshow(img, cmap=plt.cm.Greys_r if img.ndim == 2 else None)
    for i, params in enumerate(ellipses):
        c1, c2, h, w, phi = params
        rr, cc = ellipse_perimeter(int(c1), int(c2), int(h), int(w), phi,
                                   shape=seg.shape)
        ax.plot(cc, rr, '.', color=plt.cm.tab10(i % 10))
        ax.annotate('#%i with crit=%d' % (i + 1, int(crits[i])),
                    xy=(centers[i][1], centers[i][0]), color='white')
    ax.set(xlim=[0, seg.shape[1]], ylim=[seg.shape[0], 0])
    ax.axis('off')
    fig.tight_layout(pad=0)
    return fig


def figure_annot_slic_histogram_labels(dict_label_hist, slic_size=-1,
                                       slic_regul=-1):
    """Histogram of superpixel label purity."""
    plt = _pyplot('figure_annot_slic_histogram_labels')
    matrix_hist_all = np.concatenate(
        [host_array(dict_label_hist[k]) for k in dict_label_hist], axis=0)
    fig, ax = plt.subplots(figsize=(10, 5))
    for i in range(matrix_hist_all.shape[1]):
        ax.hist(matrix_hist_all[:, i], bins=50, alpha=0.5,
                label='label %i' % i)
    ax.set_title('SLIC size=%i, regul=%.3f' % (slic_size, slic_regul))
    ax.set(xlabel='label purity', ylabel='count')
    ax.legend()
    ax.grid(True)
    return fig


def figure_ray_feature(segm, points, ray_dist_raw=None, ray_dist=None,
                       points_reconst=None, title=''):
    """Ray distances around a point."""
    plt = _pyplot('figure_ray_feature')
    fig, axarr = plt.subplots(nrows=2)
    if title:
        axarr[0].set_title(title)
    axarr[0].imshow(1 - host_array(segm), cmap='Greys')
    points = host_array(points)
    axarr[0].plot(points[1], points[0], 'bo')
    if points_reconst is not None:
        points_reconst = host_array(points_reconst)
        axarr[0].plot(points_reconst[:, 1], points_reconst[:, 0], 'g.')
    if ray_dist_raw is not None:
        axarr[1].plot(host_array(ray_dist_raw), 'b', label='original')
    if ray_dist is not None:
        axarr[1].plot(host_array(ray_dist), 'g', label='final')
    axarr[1].legend(loc=0)
    axarr[1].grid()
    return fig


def figure_used_samples(img, labels, slic, used_samples, fig_size=12):
    """Which superpixels entered training."""
    plt = _pyplot('figure_used_samples')
    labels = host_array(labels)
    slic = host_array(slic)
    img = host_array(img)
    used = host_array(used_samples)[slic]
    fig, axarr = plt.subplots(ncols=2, figsize=(fig_size, fig_size // 2))
    axarr[0].imshow(labels[slic], cmap=plt.cm.jet)
    axarr[0].set_title('assigned labels')
    axarr[1].imshow(img, cmap=plt.cm.Greys_r if img.ndim == 2 else None)
    axarr[1].imshow(used, alpha=0.3, cmap=plt.cm.RdYlGn)
    axarr[1].set_title('used samples')
    for ax in axarr:
        ax.axis('off')
    fig.tight_layout()
    return fig


def draw_image_segm_points(ax, img, points, labels=None, slic=None,
                           seg_contour=None, lut_label_marker=None):
    """Points over the image, with a marker per label."""
    plt = _pyplot('draw_image_segm_points')
    img = host_array(img)
    ax.imshow(img, cmap=plt.cm.Greys_r if img.ndim == 2 else None)
    if slic is not None:
        boundaries = _slic_boundaries(slic)
        ax.contour(boundaries, levels=[0.5], colors='w', linewidths=0.5)
    points = host_array(points)
    if labels is None:
        ax.plot(points[:, 1], points[:, 0], 'o', color='b')
    else:
        labels = host_array(labels)
        markers = lut_label_marker or {-1: ('0.25', 'x'), 0: ('0.75', '.'),
                                       1: ('r', '.')}
        for lb, (color, marker) in markers.items():
            sel = labels == lb
            ax.plot(points[sel, 1], points[sel, 0], marker, color=color)
    if seg_contour is not None:
        ax.contour(host_array(seg_contour), colors='y', linewidths=1)
    ax.axis('off')


def _slic_boundaries(slic):
    slic = host_array(slic)
    b = np.zeros(slic.shape, bool)
    b[:-1, :] |= slic[:-1, :] != slic[1:, :]
    b[:, :-1] |= slic[:, :-1] != slic[:, 1:]
    return b


def figure_image_segm_centres(img, segm, centers=None, cmap_contour=None):
    """Image + segmentation contour + centres; the contour's colormap is
    matplotlib's ``Blues`` unless given."""
    plt = _pyplot('figure_image_segm_centres')
    if cmap_contour is None:
        cmap_contour = plt.cm.Blues
    img = host_array(img)
    segm = host_array(segm)
    fig, ax = plt.subplots()
    ax.imshow(img, cmap=plt.cm.Greys_r if img.ndim == 2 else None)
    if np.sum(segm) > 0:
        ax.contour(segm, cmap=cmap_contour)
    if centers is not None and len(centers):
        centers = np.asarray(host_array(centers))
        ax.plot(centers[:, 1], centers[:, 0], 'o', color='r')
    ax.axis('off')
    fig.tight_layout()
    return fig


def draw_graphcut_weighted_edges(segments, centers, edges, edge_weights,
                                 img_bg=None, img_alpha=0.5):
    """Superpixel graph edges coloured by weight (``plasma``), rendered
    through a figure canvas; returns an RGB image."""
    plt = _pyplot('draw_graphcut_weighted_edges')
    segments = host_array(segments)
    if img_bg is not None:
        img = np.asarray(host_array(img_bg), float)
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        img = img * img_alpha
        if img.max() > 1:
            img = img / 255.0
    else:
        img = np.zeros(segments.shape + (3,))
    fig, ax = plt.subplots(figsize=(8, 8 * segments.shape[0]
                                    / segments.shape[1]))
    ax.imshow(img)
    centers = host_array(centers)
    w = np.asarray(host_array(edge_weights), float)
    w = w / max(w.max(), 1e-12)
    cmap = plt.get_cmap('plasma')
    for (a, b), wi in zip(host_array(edges), w):
        ax.plot([centers[a][1], centers[b][1]], [centers[a][0], centers[b][0]],
                color=cmap(wi), linewidth=0.7)
    ax.axis('off')
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return buf


def draw_rg2sp_results(ax, seg, slic, debug_rg2sp, iter_index=-1):
    """One RG2Sp iteration over the scene."""
    plt = _pyplot('draw_rg2sp_results')
    ax.set_title('Iteration #%i with E=%.0f'
                 % (iter_index, round(debug_rg2sp['criteria'][iter_index])))
    ax.imshow(host_array(debug_rg2sp['labels'][iter_index])[host_array(slic)],
              cmap=plt.cm.jet)
    ax.contour(host_array(seg), levels=np.unique(host_array(seg)),
               colors='#bfbfbf')
    for centre in host_array(debug_rg2sp['centres'][iter_index]):
        ax.plot(centre[1], centre[0], 'ow')
    ax.axis('off')
    return ax


def figure_rg2sp_debug_complete(seg, slic, debug_rg2sp, iter_index=-1,
                                max_size=5):
    """Full RG2Sp debug sheet: labels, criteria, shape costs."""
    plt = _pyplot('figure_rg2sp_debug_complete')
    nb_objects = host_array(debug_rg2sp['lut_data_cost']).shape[1] - 1
    nb_subfigs = min(3, nb_objects)
    fig, axarr = plt.subplots(2, nb_subfigs + 1,
                              figsize=(max_size * (nb_subfigs + 1),
                                       max_size * 2), squeeze=False)
    draw_rg2sp_results(axarr[0, 0], seg, slic, debug_rg2sp, iter_index)

    axarr[0, 1].plot(debug_rg2sp['criteria'])
    axarr[0, 1].plot(iter_index, debug_rg2sp['criteria'][iter_index], 'og')
    axarr[0, 1].set_ylabel('criteria')
    axarr[0, 1].grid(True)

    slic_arr = host_array(slic)
    for j in range(nb_subfigs):
        axarr[1, j].set_title('shape cost for object #%i' % (j + 1))
        cost = host_array(debug_rg2sp['lut_shape_cost'][iter_index])[:, j + 1]
        axarr[1, j].imshow(cost[slic_arr], cmap=plt.cm.jet)
        ctr = debug_rg2sp['centres'][iter_index][j]
        axarr[1, j].plot(ctr[1], ctr[0], 'or')
        axarr[1, j].axis('off')
    fig.tight_layout()
    return fig


def draw_image_clusters_centers(ax, img, centres, points=None,
                                labels_centre=None, segm=None):
    """Detected centre clusters over the image."""
    plt = _pyplot('draw_image_clusters_centers')
    if img is not None:
        img = host_array(img)
        img = (np.asarray(img, float) / float(np.max(img))
               if np.max(img) > 0 else np.asarray(img, float))
        ax.imshow(img, cmap=plt.cm.Greys_r)
        ax.set(xlim=[0, img.shape[1]], ylim=[img.shape[0], 0])
    if segm is not None:
        ax.contour(host_array(segm))
    if points is not None and len(points) and labels_centre is not None:
        points = host_array(points)
        labels = host_array(labels_centre)
        for i in range(int(labels.max()) + 1):
            sel = points[labels == i]
            ax.plot(sel[:, 1], sel[:, 0], '.', color=plt.cm.tab10(i % 10))
    centres = np.asarray(host_array(centres))
    if len(centres):
        ax.plot(centres[:, 1], centres[:, 0], 'oy')
    ax.axis('off')


def figure_segm_boundary_dist(segm_ref, segm, subfig_size=9):
    """Boundary distance-map figure."""
    plt = _pyplot('figure_segm_boundary_dist')
    from scipy import ndimage
    segm_ref = host_array(segm_ref)
    segm = host_array(segm)
    segm_boundary = _slic_boundaries(segm)
    dist = ndimage.distance_transform_edt(~_slic_boundaries(segm_ref))
    fig_size = (2 * subfig_size, subfig_size
                * segm_ref.shape[0] / segm_ref.shape[1])
    fig, axarr = plt.subplots(ncols=2, figsize=fig_size)
    axarr[0].set_title('boundary distances')
    im = axarr[0].imshow(dist, cmap=plt.cm.Greys)
    plt.colorbar(im, ax=axarr[0])
    axarr[0].contour(segm, cmap=plt.cm.jet)
    axarr[1].set_title('distances on boundary')
    axarr[1].imshow(dist * segm_boundary, cmap=plt.cm.Reds)
    for ax in axarr:
        ax.axis('off')
    fig.tight_layout()
    return fig
