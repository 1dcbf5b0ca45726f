"""Write the JAX-CPU reference fixture that the PyTorch port is checked against.

Fits the group class model with the JAX package over two synthetic colour
images at the bench geometry (884x1200, sp_size 35, regul 0.2, 3 classes),
then segments image 0 and stores two files:

* ``torch_port_fixture.npz``: the fitted ``ClassModel`` arrays (the weight
  carrier ``pyimsegm_tpu_torch.models.class_model.class_model_from_numpy``
  reads) and the ``connectivity=False`` segmentation ``segm`` (uint8) and
  SLIC labels ``slic`` (int16);
* ``torch_port_fixture_conn.npz``: the ``connectivity=True`` (default)
  segmentation ``segm`` and enforced SLIC labels ``slic`` under the same
  model;
* ``torch_port_fixture_fit.npz``: the unsupervised fit path on image 0
  (``pipe_color2d_slic_features_model_graphcut`` with the full colour
  feature set, GMM fitted on the image): the enforced non-fused SLIC labels
  ``slic`` (int16), the (K, 15) ``features`` and their sample ``weight``,
  the fitted model arrays, the segmentation ``segm`` (uint8), and the
  enforced SLICO labels ``slico`` of ``segment_slic_img2d(..., slico=True)``
  (int16);
* ``torch_port_fixture_3d.npz``: the 3D gray-volume pipe
  (``pipe_gray3d_slic_features_model_graphcut``, mean / std / energy, a
  2-class GMM fitted on the volume, gc_regul 0.1, sp_regul 0.2) on the
  structured volume of ``sample_gray_volume_3d`` at the repo's 3D workload
  (48x640x768, sp_size 15, spacing (4, 1, 1)) and at a small test size
  (8x40x48, sp_size 8, spacing (2, 1, 1), keys prefixed ``small_``): the
  SLIC labels of three z-slices ``slic`` (int16, slice indices in
  ``slices``), the segmentation ``segm_bits`` (``np.packbits`` of the
  uint8 map, shape in ``shape``), the standardised (K, 3) ``features``
  with their sample weight ``mask``, the fitted model arrays, and the
  (K, 2) ``digest`` of the whole SLIC labelling
  (``pyimsegm_tpu_torch.utils.metrics.segment_digest``), which tells the
  supervoxels whose voxel sets a port run reproduces;
* ``torch_port_fixture_sup.npz``: the supervised path of BASELINE config 2
  at the bench geometry: ``train_classif_color2d_slic_features`` on images
  0-2 and their annotations with ``nb_classif_search=3``, once with cfg2's
  features (colour + tGabor + tLBP) and once with its reference-matching
  family (colour + tLM, keys suffixed ``_tlm``); each forest's arrays
  (``clf_*``, the arrays ``pyimsegm_tpu_torch.classification.
  classifier_from_numpy`` reads), its training set (``train_features``,
  ``train_labels``) and its accuracy on it (``train_acc``); then image 0
  segmented with it (gc_regul 5.0): the enforced SLIC labels ``slic``
  (int16), the (K, F) ``features`` and their ``names``, ``proba``, the
  segmentation ``segm`` (uint8) and its ARS against the annotation
  (``ars_annot``);
* ``torch_port_fixture_clf.npz``: config 2's training set (its features of
  images 0-2 and the superpixel labels, as
  ``train_classif_color2d_slic_features`` builds it: ``train_features``,
  ``train_labels``) and, for each of GradBoost, AdaBoost, LogistRegr, SVM,
  KNN and MLP (keys prefixed ``<name>_``), the classifier the JAX package
  trains on it with a 3-candidate search (its arrays ``clf_*``, as
  ``classifier_from_numpy`` reads them, and ``hyper``), its accuracy on
  the training set (``train_acc``), and image 0 segmented with it (gc_regul
  5.0): ``proba`` as the pipeline takes it, ``proba_clf`` of
  ``Classifier.predict_proba`` on the same features, ``segm`` (uint8) and
  its ARS against the annotation (``ars_annot``); the enforced SLIC labels
  ``slic`` (int16), ``features`` and ``names`` of image 0 are shared;
* ``torch_port_fixture_3d_tlm.npz``: the 3D gray-volume pipe with LM
  texture (colour mean / std / energy and ``tLM`` mean: 23 features) on
  the structured volume at 8x160x192 (the 3D workload's sp_size 15 and
  spacing (4, 1, 1)), with the same arrays as the 3D file;
* ``torch_port_fixture_noise.npz``: the first two images of ``bench.py``'s
  noise fallback (``default_rng(0)``, 884x1200) segmented with the group
  model of ``torch_port_fixture.npz``: for image i, the SLIC labels
  ``slic<i>`` of the ``connectivity=False`` call, and the enforced labels
  ``enforced<i>`` (int16) and segmentation ``segm<i>`` (uint8) of the
  default call;
* ``torch_port_fixture_centers.npz``: BASELINE config 4 at the ovary
  image's size (647x1024) on the synthetic scenes of
  ``pyimsegm_tpu_torch.utils.data_samples.sample_ovary_scene`` (seeds
  ``CENTER_TRAIN_SEEDS`` to train, ``CENTER_TEST_SEED`` to detect): the
  forest of ``centers.train_center_classifier`` with one search candidate
  (``clf_*``), its training set (``train_features``, ``train_labels``);
  on the test scene, the fused ``load_compute_detect_centers`` outputs
  (``slic`` int16, ``points``, ``candidates``, ``centers``,
  ``clust_labels``), the (P, 44) ``features`` at the points (annuli
  histograms and aligned rays), the rays before the alignment (``rays``)
  and their ``shifts``, and the
  detection's ``recall`` / ``precision`` against the true centres; then the
  ellipse chain on the true centres: the gray SLIC of
  ``get_slic_points_labels`` (``ell_slic``, int16), the boundary points of
  ``prepare_boundary_points_ray_edge`` (``ell_points``, stacked, with
  ``ell_counts`` per centre), the RANSAC parameters (``ell_params``, NaN
  rows for no model) and inlier counts under ``np.random.seed(0)``, and the
  object map of ``add_overlap_ellipse`` (``ell_segm``, uint8).

A file whose arrays are unchanged is not rewritten, so its bytes stay as
committed.  ``chip_smoke.py`` reads both on the GPU machine, which has no
JAX.

Run on the CPU (a few minutes; ``--only-3d`` writes the 3D file alone,
``--only-sup`` the supervised one, ``--only-noise`` the noise one,
``--only-clf`` the classifier one, ``--only-3d-tlm`` the 3D texture one,
``--only-centers`` the centre-detection one, ~10 min, ``--only-rg2sp`` the
region-growing one, ~5 min, ``--only-rest`` the one of the ovary zoo's
snakes)::

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py \
        [--only-3d | --only-sup | --only-noise | --only-clf | --only-3d-tlm
         | --only-centers | --only-rg2sp | --only-rest]

``torch_port_fixture_rest.npz`` holds JAX's outputs of ``chip_smoke.py``
phase 14 on the test ovary scene (its inputs are rebuilt from their
seeds by ``chip_smoke.py``'s helpers): the ovary zoo's SLIC at sp_size 40,
regul 0.3 (``slic``, int16), the label maps of its ``morph-snakes_img``
and ``morph-snakes_seg`` methods (``morph_snakes_img``,
``morph_snakes_seg``, uint8) and the nearest-colour indices of the
perturbed annotation (``quant``, uint8).

``torch_port_fixture_rg2sp.npz`` holds BASELINE config 5 on the synthetic
ovary scenes at 647x1024: the shape model JAX fits on the egg masks of the
training scenes (``shape_*`` arrays of
``pyimsegm_tpu_torch.region_growing.shape_model_to_numpy``, and their
``rays``), the test scene's SLIC (int16), ``prob_fg`` and true centres,
the GraphCut and greedy RG2Sp labels with their iteration counts, those
of GraphCut RG2Sp on a second scene whose labels take the grid solve
(``grid_*``), the
one-shot object GraphCut on the superpixels and on the pixels (labels and
energy), the compat SLIC's raw and enforced labels (int16), and the
``sp_compat`` segmentation with the class model it used.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture.npz')
OUT_CONN = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_conn.npz')
OUT_FIT = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_fit.npz')
OUT_3D = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_3d.npz')
OUT_SUP = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_sup.npz')
OUT_NOISE = os.path.join(ROOT, 'tests', 'data',
                         'torch_port_fixture_noise.npz')
OUT_CLF = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_clf.npz')
OUT_3D_TLM = os.path.join(ROOT, 'tests', 'data',
                          'torch_port_fixture_3d_tlm.npz')
OUT_CENTERS = os.path.join(ROOT, 'tests', 'data',
                           'torch_port_fixture_centers.npz')
OUT_RG2SP = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_rg2sp.npz')
OUT_REST = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_rest.npz')
CROP = (884, 1200)
SP_SIZE, SP_REGUL, GC_REGUL, NB_CLASSES = 35, 0.2, 2.0, 3
FEATURES = {'color': ['mean', 'std', 'energy']}
FEATURES_FIT = {'color': ['mean', 'std', 'energy', 'median', 'meanGrad']}
#: (prefix, volume shape, sp_size, spacing, stored z-slices) of the 3D file
CASES_3D = (('', (48, 640, 768), 15, (4, 1, 1), (0, 23, 47)),
            ('small_', (8, 40, 48), 8, (2, 1, 1), (0, 3, 7)))
SP_REGUL_3D, GC_REGUL_3D, NB_CLASSES_3D = 0.2, 0.1, 2
FEATURES_3D = {'color': ['mean', 'std', 'energy']}
#: BASELINE config 2 (bench_all.py): its features, the reference-matching
#: family, the MRF weight, the images trained on and the search size
FEATURES_SUP = {'color': ['mean', 'std', 'energy'],
                'tGabor': ['mean', 'energy'], 'tLBP': ['mean']}
FEATURES_TLM = {'color': ['mean', 'std', 'energy'],
                'tLM': ['mean', 'std', 'energy']}
GC_REGUL_SUP, N_TRAIN_SUP, SEARCH_SUP = 5.0, 3, 3
#: the classifier families of the classifier file
CLF_NAMES = ('GradBoost', 'AdaBoost', 'LogistRegr', 'SVM', 'KNN', 'MLP')
#: the 3D texture file's volume, features and stored slices
CASE_3D_TLM = ((8, 160, 192), 15, (4, 1, 1), (0, 3, 7))
FEATURES_3D_TLM = {'color': ['mean', 'std', 'energy'], 'tLM': ['mean']}
#: config 4: the ovary image's size, the scenes' seeds and egg count, the
#: ellipse chain's tissue table (background, follicle, nurse, oocyte),
#: SLIC, RANSAC and overlap parameters
OVARY = (647, 1024)
CENTER_TRAIN_SEEDS, CENTER_TEST_SEED, N_EGGS = (0, 1, 2), 3, 4
TABLE_PROB = [0.01, 0.95, 0.95, 0.85]
ELL_SLIC, ELL_REGUL, ELL_INLIERS, ELL_THR, ELL_TRIALS, ELL_OVERLAP = \
    15, 0.1, 0.35, 3, 30, 0.45
#: config 5 (bench_all.py): the shape model's training scenes (24 eggs: on
#: the 12 of seeds 0-2 alone, fewer than the 15 ray directions, JAX's f32
#: mixture fit is NaN), the SLIC, the tissue table, the RG2Sp energy, the
#: one-shot GraphCut's radial prior, and the compat SLIC's class count
RG_SHAPE_SEEDS, RG_TEST_SEED = (0, 1, 2, 4, 5, 6), 3
#: a second test scene whose SLIC keeps all K = 3,036 labels, so that RG2Sp
#: takes the grid solve (seed 3's merge empties the last two labels, and
#: K = 3,034 takes the edge-list solve in both packages)
RG_GRID_SEED = 10
RG_SP, RG_REGUL, RG_RAY_STEP = 15, 0.2, 25
RG_TABLE = [0.1, 0.9, 0.75, 0.9, 0.9]
RG_PARAMS = dict(coef_shape=5., coef_pairwise=15.,
                 prob_label_trans=[0.1, 0.03], nb_iter=100)
RG_OBJ_SHAPE = dict(coef_shape=1., shape_mean_std=(100., 20.))
RG_COMPAT_CLASSES = 3
_MODEL_ARRAYS = ('scaler_mean', 'scaler_scale', 'pca_components', 'pca_mean',
                 'pca_mask')


def _save(path, arrays):
    """Write ``arrays`` to ``path`` unless it already holds exactly them."""
    if os.path.isfile(path):
        with np.load(path) as old:
            if set(old.files) == set(arrays) and all(
                    old[k].dtype == v.dtype and np.array_equal(old[k], v)
                    for k, v in arrays.items()):
                print('unchanged %s' % path)
                return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)
    print('wrote %s (%d bytes)' % (path, os.path.getsize(path)))


def main():
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from pyimsegm_tpu import pipelines
    from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment

    if '--only-sup' in sys.argv[1:]:
        _save(OUT_SUP, _sup_outputs(pipelines))
        return
    if '--only-centers' in sys.argv[1:]:
        _save(OUT_CENTERS, _centers_outputs())
        return
    if '--only-rg2sp' in sys.argv[1:]:
        _save(OUT_RG2SP, _rg2sp_outputs(pipelines))
        return
    if '--only-rest' in sys.argv[1:]:
        _save(OUT_REST, _rest_outputs())
        return
    if '--only-clf' in sys.argv[1:]:
        _save(OUT_CLF, _clf_outputs(pipelines))
        return
    if '--only-3d-tlm' in sys.argv[1:]:
        _save(OUT_3D_TLM, _gray3d_outputs(pipelines, '', *CASE_3D_TLM,
                                          features=FEATURES_3D_TLM))
        return
    if '--only-noise' in sys.argv[1:]:
        model = _group_model(pipelines)
        with np.load(OUT) as old:
            for k, v in _model_arrays(model).items():
                np.testing.assert_array_equal(old[k], v)
        _save(OUT_NOISE, _noise_outputs(pipelines, model))
        return
    arrays_3d = {}
    for case in CASES_3D:
        arrays_3d.update(_gray3d_outputs(pipelines, *case))
    _save(OUT_3D, arrays_3d)
    if '--only-3d' in sys.argv[1:]:
        return
    imgs = [sample_color_image_rand_segment(CROP, NB_CLASSES, rand_seed=s)[0]
            for s in (0, 1)]
    model = _group_model(pipelines)
    outputs = {}
    for conn in (False, True):
        dv = {}
        segm, _soft = pipelines.segment_color2d_slic_features_model_graphcut(
            imgs[0], model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL, debug_visual=dv, connectivity=conn)
        outputs[conn] = {'segm': np.asarray(segm).astype(np.uint8),
                         'slic': np.asarray(dv['slic']).astype(np.int16)}

    _save(OUT, dict(outputs[False], **_model_arrays(model)))
    _save(OUT_CONN, outputs[True])
    _save(OUT_FIT, _fit_outputs(pipelines, imgs[0]))
    _save(OUT_SUP, _sup_outputs(pipelines))
    _save(OUT_NOISE, _noise_outputs(pipelines, model))
    _save(OUT_CLF, _clf_outputs(pipelines))
    _save(OUT_3D_TLM, _gray3d_outputs(pipelines, '', *CASE_3D_TLM,
                                      features=FEATURES_3D_TLM))
    _save(OUT_CENTERS, _centers_outputs())
    _save(OUT_RG2SP, _rg2sp_outputs(pipelines))
    _save(OUT_REST, _rest_outputs())


def _rest_outputs():
    """JAX's SLIC, snakes and quantisation of ``chip_smoke.py`` phase 14,
    the inputs from ``chip_smoke.py``'s own helpers."""
    import chip_smoke
    from apps.run_ovary_egg_segmentation import segment_morphsnakes
    from pyimsegm_tpu import annotation
    from pyimsegm_tpu.ops import snakes
    from pyimsegm_tpu.ops.slic import segment_slic_img2d
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    img, segm, centres = sample_ovary_scene(OVARY, N_EGGS,
                                            rand_seed=chip_smoke.REST_SEED)
    out = {'slic': np.asarray(segment_slic_img2d(
        img, sp_size=chip_smoke.REST_SP,
        relative_compact=chip_smoke.REST_REGUL)).astype(np.int16)}
    for method in chip_smoke.SNAKES:
        image, masks, n_iter, smoothing, lambdas = chip_smoke.snake_call(
            method, img, segm, centres)
        labels = np.asarray(snakes.morph_acwe_multi(
            image, masks, n_iter=n_iter, smoothing=smoothing,
            lambda1=lambdas[0], lambda2=lambdas[1]))
        if method == 'morph-snakes_img':
            # the app's own entry point gives the same map
            np.testing.assert_array_equal(
                labels, segment_morphsnakes(img, centres))
        out[method.replace('-', '_')] = labels.astype(np.uint8)
    out['quant'] = np.asarray(annotation.image_color_2_labels(
        chip_smoke.annotation_image(segm),
        list(annotation.DICT_COLOURS.values()))).astype(np.uint8)
    return out


def _group_model(pipelines):
    """The group class model over synthetic images 0 and 1."""
    from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
    imgs = [sample_color_image_rand_segment(CROP, NB_CLASSES, rand_seed=s)[0]
            for s in (0, 1)]
    return pipelines.estim_model_classes_group(
        imgs, NB_CLASSES, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL)[0]


def _noise_outputs(pipelines, model):
    """bench.py's first two noise images through the bench-path call."""
    rng = np.random.default_rng(0)
    arrays = {}
    for i in range(2):
        img = rng.random(CROP + (3,), dtype=np.float32)
        for conn in (False, True):
            dv = {}
            segm, _ = pipelines.segment_color2d_slic_features_model_graphcut(
                img, model, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL,
                gc_regul=GC_REGUL, debug_visual=dv, connectivity=conn)
            if conn:
                arrays['enforced%d' % i] = np.asarray(dv['slic'], np.int16)
                arrays['segm%d' % i] = np.asarray(segm).astype(np.uint8)
            else:
                arrays['slic%d' % i] = np.asarray(dv['slic'], np.int16)
    return arrays


def _model_arrays(model):
    arrays = {'weights': model.gmm.weights, 'means': model.gmm.means,
              'covs': model.gmm.covs}
    for name in _MODEL_ARRAYS:
        val = getattr(model, name)
        if val is not None:
            arrays[name] = val
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


def _fit_outputs(pipelines, img):
    """The unsupervised fit path and the SLICO labels on one image."""
    from pyimsegm_tpu import superpixels
    dv = {}
    segm, _soft = pipelines.pipe_color2d_slic_features_model_graphcut(
        img, NB_CLASSES, FEATURES_FIT, sp_size=SP_SIZE, sp_regul=SP_REGUL,
        gc_regul=GC_REGUL, estim_model='GMM', debug_visual=dv)
    slic = np.asarray(dv['slic'])
    k = dv['features'].shape[0]
    weight = (np.bincount(slic.ravel(), minlength=k)[:k] > 0)
    slico = superpixels.segment_slic_img2d(img, sp_size=SP_SIZE,
                                           relative_compact=SP_REGUL,
                                           slico=True)
    return dict(_model_arrays(dv['model']),
                segm=np.asarray(segm).astype(np.uint8),
                slic=slic.astype(np.int16),
                features=np.asarray(dv['features'], np.float32),
                weight=weight.astype(np.float32),
                slico=np.asarray(slico).astype(np.int16))


def _sup_outputs(pipelines):
    """Config 2's training and image 0's segmentation, for both feature
    families."""
    import jax.numpy as jnp
    from pyimsegm_tpu import classification, descriptors
    from pyimsegm_tpu.ops import slic as slic_ops
    from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
    from pyimsegm_tpu.utils.metrics import adjusted_rand_score
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    pairs = [sample_color_image_rand_segment(CROP, NB_CLASSES, rand_seed=s)
             for s in range(N_TRAIN_SUP)]
    imgs, annots = [p[0] for p in pairs], [p[1] for p in pairs]
    out = {}
    for suffix, feats in (('', FEATURES_SUP), ('_tlm', FEATURES_TLM)):
        classif, _slic, list_feats, list_lbs = \
            pipelines.train_classif_color2d_slic_features(
                imgs, annots, feats, sp_size=SP_SIZE, sp_regul=SP_REGUL,
                nb_classif_search=SEARCH_SUP)
        x, y, _ = classification.convert_set_features_labels_2_dataset(
            dict(enumerate(list_feats)), dict(enumerate(list_lbs)),
            balance_type='unique', drop_labels=[-1])
        dv = {}
        segm, _soft = pipelines.segment_color2d_slic_features_model_graphcut(
            imgs[0], classif, feats, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            gc_regul=GC_REGUL_SUP, debug_visual=dv)
        slic = np.asarray(dv['slic'])
        features, names = descriptors.compute_selected_features_color2d(
            jnp.asarray(imgs[0]), jnp.asarray(slic.ravel()), cfg.n_segments,
            feats, grid_ctx=(jnp.asarray(slic), cfg))
        p = classif._params
        arrays = {
            'clf_classes': np.asarray(classif.classes_),
            'clf_scaler_mean': np.asarray(classif._scaler[0], np.float32),
            'clf_scaler_std': np.asarray(classif._scaler[1], np.float32),
            'clf_feat': np.asarray(p.feat, np.int32),
            'clf_thr': np.asarray(p.thr, np.float32),
            'clf_leaf_proba': np.asarray(p.leaf_proba, np.float32),
            'clf_depth': np.asarray(int(p.depth), np.int32),
            'train_features': np.asarray(x, np.float32),
            'train_labels': np.asarray(y, np.int8),
            'train_acc': np.asarray(classif.score(x, y), np.float64),
            'slic': slic.astype(np.int16),
            'features': np.nan_to_num(np.asarray(features, np.float32)),
            'names': np.asarray(names),
            'proba': np.asarray(dv['proba'], np.float32),
            'segm': np.asarray(segm).astype(np.uint8),
            'ars_annot': np.asarray(adjusted_rand_score(segm, annots[0]),
                                    np.float64)}
        print('supervised%s: %d training samples, accuracy %.4f, hyper %r, '
              'image 0 ARS vs annotation %.4f'
              % (suffix, len(y), float(arrays['train_acc']), classif.hyper,
                 float(arrays['ars_annot'])))
        out.update({k + suffix: v for k, v in arrays.items()})
    return out


def _clf_arrays(classif):
    """The arrays of a JAX classifier that ``classifier_from_numpy`` of the
    port reads."""
    out = {'classes': np.asarray(classif.classes_),
           'scaler_mean': np.asarray(classif._scaler[0], np.float32),
           'scaler_std': np.asarray(classif._scaler[1], np.float32)}
    for k, v in classif._params._asdict().items():
        v = np.asarray(v)
        out[k] = (v.astype(np.int32) if v.dtype.kind in 'iub' and v.ndim
                  else v.astype(np.float32) if v.ndim else v)
    return out


def _clf_outputs(pipelines):
    """Config 2's training set, a JAX classifier of each family trained on
    it, and image 0 segmented with each."""
    import json
    import jax.numpy as jnp
    from pyimsegm_tpu import classification, descriptors
    from pyimsegm_tpu.ops import slic as slic_ops
    from pyimsegm_tpu.utils.data_samples import sample_color_image_rand_segment
    from pyimsegm_tpu.utils.metrics import adjusted_rand_score
    cfg = slic_ops.slic_config(CROP[0], CROP[1], SP_SIZE)
    pairs = [sample_color_image_rand_segment(CROP, NB_CLASSES, rand_seed=s)
             for s in range(N_TRAIN_SUP)]
    imgs, annots = [p[0] for p in pairs], [p[1] for p in pairs]
    # the first family through the training entry point; the others on the
    # same training set with its search (10-fold CV for 3 images)
    first, _slic, list_feats, list_lbs = \
        pipelines.train_classif_color2d_slic_features(
            imgs, annots, FEATURES_SUP, sp_size=SP_SIZE, sp_regul=SP_REGUL,
            clf_name=CLF_NAMES[0], nb_classif_search=SEARCH_SUP)
    x, y, _ = classification.convert_set_features_labels_2_dataset(
        dict(enumerate(list_feats)), dict(enumerate(list_lbs)),
        balance_type='unique', drop_labels=[-1])
    x = np.nan_to_num(x)
    out = {'train_features': np.asarray(x, np.float32),
           'train_labels': np.asarray(y, np.int8)}
    for name in CLF_NAMES:
        if name == CLF_NAMES[0]:
            classif, hyper = first, first.hyper
        else:
            classif, hyper = \
                classification.create_classif_search_train_export(
                    name, x, y, cross_val=10, nb_search_iter=SEARCH_SUP,
                    seed=0)
        dv = {}
        segm, _soft = pipelines.segment_color2d_slic_features_model_graphcut(
            imgs[0], classif, FEATURES_SUP, sp_size=SP_SIZE,
            sp_regul=SP_REGUL, gc_regul=GC_REGUL_SUP, debug_visual=dv)
        slic = np.asarray(dv['slic'])
        if 'slic' not in out:
            features, names = descriptors.compute_selected_features_color2d(
                jnp.asarray(imgs[0]), jnp.asarray(slic.ravel()),
                cfg.n_segments, FEATURES_SUP,
                grid_ctx=(jnp.asarray(slic), cfg))
            features = np.nan_to_num(np.asarray(features, np.float32))
            out.update(slic=slic.astype(np.int16), features=features,
                       names=np.asarray(names))
        arrays = {'clf_' + k: v for k, v in _clf_arrays(classif).items()}
        arrays.update(
            hyper=np.asarray(json.dumps(hyper)),
            train_acc=np.asarray(classif.score(x, y), np.float64),
            proba=np.asarray(dv['proba'], np.float32),
            proba_clf=np.asarray(classif.predict_proba(out['features']),
                                 np.float32),
            segm=np.asarray(segm).astype(np.uint8),
            ars_annot=np.asarray(adjusted_rand_score(segm, annots[0]),
                                 np.float64))
        print('%s: %d training samples, accuracy %.4f, hyper %r, image 0 ARS '
              'vs annotation %.4f' % (name, len(y), float(arrays['train_acc']),
                                      hyper, float(arrays['ars_annot'])))
        out.update({'%s_%s' % (name, k): v for k, v in arrays.items()})
    return out


def _rg2sp_outputs(pipelines):
    """Config 5's shape model, RG2Sp runs, one-shot GraphCuts and the
    compat SLIC on the synthetic ovary scenes."""
    import time

    import jax.numpy as jnp
    from pyimsegm_tpu import native
    from pyimsegm_tpu import region_growing as rg
    from pyimsegm_tpu.ops import graphcut
    from pyimsegm_tpu.ops import slic as slic_ops
    from pyimsegm_tpu.superpixels import segment_slic_img2d
    from pyimsegm_tpu_torch.region_growing import shape_model_to_numpy
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    annots = [(sample_ovary_scene(OVARY, N_EGGS, rand_seed=s)[1] > 0)
              .astype(np.int32) for s in RG_SHAPE_SEEDS]
    rays, _ = rg.compute_object_shapes(annots, ray_step=RG_RAY_STEP,
                                       smooth_coef=1, interp_order='spline')
    model, cdfs = rg.transform_rays_model_cdf_mixture(rays)
    img, segm, centres = sample_ovary_scene(OVARY, N_EGGS,
                                            rand_seed=RG_TEST_SEED)
    slic = np.asarray(segment_slic_img2d(img, sp_size=RG_SP,
                                         relative_compact=RG_REGUL))
    cfg = slic_ops.slic_config(OVARY[0], OVARY[1], RG_SP)
    prob_fg = rg.compute_segm_prob_fg(slic, segm, RG_TABLE)
    arrays = {'shape_' + k: v
              for k, v in shape_model_to_numpy(model, cdfs).items()}
    arrays.update(rays=np.asarray(rays, np.float64),
                  slic=slic.astype(np.int16), prob_fg=prob_fg,
                  centres=np.asarray(centres, np.float64))
    for name, fn, kw in (
            ('gc', rg.region_growing_shape_slic_graphcut,
             dict(optim_global=True, grid_cfg=cfg)),
            ('greedy', rg.region_growing_shape_slic_greedy, {})):
        hist = {}
        t0 = time.perf_counter()
        labels = fn(slic, prob_fg, centres, (model, cdfs), 'cdf',
                    debug_history=hist, **dict(RG_PARAMS, **kw))
        print('%s RG2Sp: %d iterations, %.1f s, %d superpixels in objects'
              % (name, len(hist['labels']), time.perf_counter() - t0,
                 int((labels > 0).sum())))
        arrays['%s_labels' % name] = np.asarray(labels, np.int8)
        arrays['%s_iters' % name] = np.asarray(len(hist['labels']), np.int32)
        arrays['%s_criteria' % name] = np.asarray(hist['criteria'],
                                                  np.float64)
    img_g, segm_g, centres_g = sample_ovary_scene(OVARY, N_EGGS,
                                                  rand_seed=RG_GRID_SEED)
    slic_g = np.asarray(segment_slic_img2d(img_g, sp_size=RG_SP,
                                           relative_compact=RG_REGUL))
    hist = {}
    labels = rg.region_growing_shape_slic_graphcut(
        slic_g, rg.compute_segm_prob_fg(slic_g, segm_g, RG_TABLE), centres_g,
        (model, cdfs), 'cdf', debug_history=hist, optim_global=True,
        grid_cfg=cfg, **RG_PARAMS)
    print('grid-route RG2Sp (K = %d): %d iterations'
          % (int(slic_g.max()) + 1, len(hist['labels'])))
    arrays.update(grid_slic=slic_g.astype(np.int16),
                  grid_labels=np.asarray(labels, np.int8),
                  grid_iters=np.asarray(len(hist['labels']), np.int32),
                  grid_criteria=np.asarray(hist['criteria'], np.float64))
    arrays['obj_slic_labels'] = np.asarray(
        rg.object_segmentation_graphcut_slic(
            slic, segm, centres, labels_fg_prob=RG_TABLE, **RG_OBJ_SHAPE),
        np.int8)
    t0 = time.perf_counter()
    debug = {}
    obj_px = rg.object_segmentation_graphcut_pixels(
        segm, centres, labels_fg_prob=RG_TABLE, debug_visual=debug)
    unary = np.stack(debug['unary_imgs'], axis=-1).reshape(
        -1, len(centres) + 1)
    edges = rg._grid_edges(*OVARY)
    pairwise = 1 - np.eye(len(centres) + 1)
    energy = float(graphcut.mrf_energy(
        jnp.asarray(obj_px.reshape(-1)), jnp.asarray(unary, jnp.float32),
        jnp.asarray(edges), jnp.ones(len(edges), jnp.float32),
        jnp.asarray(pairwise, jnp.float32)))
    print('pixel GraphCut: %.1f s, energy %.3f, %d object pixels'
          % (time.perf_counter() - t0, energy, int((obj_px > 0).sum())))
    arrays.update(obj_px_labels=obj_px.astype(np.uint8),
                  obj_px_energy=np.asarray(energy, np.float64))

    m = slic_ops.compactness_from_regul(RG_SP, RG_REGUL)
    raw = np.asarray(slic_ops._slic_segment_xla_skimage(
        jnp.asarray(img), cfg, m)).astype(np.int32)
    enforced = native.enforce_connectivity(
        raw, min_size=int(0.5 * cfg.step * cfg.step))
    cmodel, _ = pipelines.estim_model_classes_group(
        [img], RG_COMPAT_CLASSES, FEATURES, sp_size=RG_SP, sp_regul=RG_REGUL)
    segm_c, _ = pipelines.segment_color2d_slic_features_model_graphcut(
        img, cmodel, FEATURES, sp_size=RG_SP, sp_regul=RG_REGUL,
        gc_regul=GC_REGUL, sp_compat=True)
    print('compat SLIC: %d raw labels, %d enforced' % (
        len(np.unique(raw)), int(enforced.max()) + 1))
    arrays.update(compat_raw=raw.astype(np.int16),
                  compat_enforced=enforced.astype(np.int16),
                  compat_segm=np.asarray(segm_c).astype(np.uint8),
                  **{'compat_model_' + k: v
                     for k, v in _model_arrays(cmodel).items()})
    return arrays


def _centers_outputs():
    """Config 4's training, detection and ellipse chain on the synthetic
    ovary scenes."""
    import jax.numpy as jnp
    from pyimsegm_tpu import centers, ellipse_fitting
    from pyimsegm_tpu.ops import histogram, ray
    from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene
    scenes = [sample_ovary_scene(OVARY, N_EGGS, rand_seed=s)
              for s in CENTER_TRAIN_SEEDS + (CENTER_TEST_SEED,)]
    classif, data = centers.train_center_classifier(
        [s[1] for s in scenes[:-1]], [s[0] for s in scenes[:-1]],
        [s[2] for s in scenes[:-1]], params={'nb_classif_search': 1})
    img, segm, true_centres = scenes[-1]
    out = centers.load_compute_detect_centers(img, segm, classif)
    params = dict(centers.CENTER_PARAMS)
    points = out['points']
    hist, _ = histogram.compute_label_histograms_positions(
        segm, points.astype(np.int32), tuple(params['fts_hist_diams']))
    raw = ray.ray_features_positions_core(
        jnp.asarray(segm == 0), jnp.asarray(points, jnp.float32),
        angle_step=float(params['fts_ray_step']), edge='up')
    rays, shifts = ray.shift_ray_features_batched(raw)
    stats = centers.evaluate_detected_centers(
        out['centers'], true_centres, params['center_dist_thr'])
    print('centres: %d training points, %d points, %d candidates, %d '
          'centres, recall %.4f, precision %.4f'
          % (sum(len(d['points']) for d in data.values()), len(points),
             len(out['candidates']), len(out['centers']), stats['recall'],
             stats['precision']))
    train_x = np.concatenate([d['features'] for d in data.values()])
    train_y = np.concatenate([d['labels'] for d in data.values()])
    arrays = {'clf_' + k: v for k, v in _clf_arrays(classif).items()}
    arrays.update(
        train_features=train_x.astype(np.float32),
        train_labels=train_y.astype(np.int8),
        slic=np.asarray(out['slic']).astype(np.int16),
        points=np.asarray(points, np.float32),
        candidates=np.asarray(out['candidates'], np.float32),
        centers=np.asarray(out['centers'], np.float64).reshape(-1, 2),
        clust_labels=np.asarray(out['clust_labels'], np.int32),
        features=np.concatenate([np.asarray(hist), np.asarray(rays)],
                                axis=1).astype(np.float32),
        rays=np.asarray(raw, np.float32),
        shifts=np.asarray(shifts, np.float32),
        recall=np.asarray(stats['recall'], np.float64),
        precision=np.asarray(stats['precision'], np.float64))

    slic, points_all, labels = ellipse_fitting.get_slic_points_labels(
        segm, slic_size=ELL_SLIC, slic_regul=ELL_REGUL)
    weights = np.bincount(slic.ravel())
    boundary = ellipse_fitting.prepare_boundary_points_ray_edge(
        segm, true_centres, close_points=5)
    np.random.seed(0)
    obj = np.zeros(segm.shape, dtype=int)
    ell, n_in = [], []
    for i, pts in enumerate(boundary):
        model, inliers = ellipse_fitting.ransac_segm(
            np.asarray(pts), ellipse_fitting.EllipseModelSegm, points_all,
            weights, labels, [TABLE_PROB], ELL_INLIERS, ELL_THR,
            max_trials=ELL_TRIALS)
        if model is None:
            ell.append(np.full(5, np.nan))
            n_in.append(-1)
            continue
        ell.append(np.asarray(model.params, np.float64))
        n_in.append(int(np.sum(inliers)))
        obj = ellipse_fitting.add_overlap_ellipse(obj, model.params, i + 1,
                                                  thr_overlap=ELL_OVERLAP)
    print('ellipses: %d centres, boundary points %s, inliers %s, object '
          'pixels %d' % (len(boundary), [len(b) for b in boundary], n_in,
                         int((obj > 0).sum())))
    arrays.update(
        ell_slic=np.asarray(slic).astype(np.int16),
        ell_points=np.concatenate(boundary).astype(np.float64),
        ell_counts=np.asarray([len(b) for b in boundary], np.int32),
        ell_params=np.asarray(ell, np.float64),
        ell_inliers=np.asarray(n_in, np.int32),
        ell_segm=obj.astype(np.uint8))
    return arrays


def _gray3d_outputs(pipelines, prefix, shape, sp_size, spacing, slices,
                    features=FEATURES_3D):
    """The 3D pipe's stages (SLIC, counts, standardised features, GMM fit)
    as ``_pipe_gray3d_core`` runs them, and the public call's
    segmentation."""
    import jax.numpy as jnp
    from pyimsegm_tpu import descriptors
    from pyimsegm_tpu.models.class_model import estim_class_model
    from pyimsegm_tpu.ops import slic3d
    from pyimsegm_tpu.ops.slic import compactness_from_regul
    from pyimsegm_tpu_torch.utils.data_samples import sample_gray_volume_3d
    from pyimsegm_tpu_torch.utils.metrics import segment_digest

    vol, _ = sample_gray_volume_3d(shape)
    cfg = slic3d.slic3d_config(vol.shape, sp_size, spacing)
    m = compactness_from_regul(sp_size, SP_REGUL_3D)
    volj = jnp.asarray(vol)
    labels = slic3d.slic3d_segment(volj, cfg, m)
    counts = slic3d.grid3d_segment_sum(
        jnp.ones(labels.shape + (1,), jnp.float32), labels, cfg)[:, 0]
    mask = (counts > 0).astype(jnp.float32)
    feats, _ = descriptors.compute_selected_features_gray3d(
        volj, labels.ravel(), cfg.n_segments, features,
        grid_ctx3d=(labels, cfg))
    mu = jnp.sum(feats * mask[:, None], 0) / jnp.maximum(jnp.sum(mask), 1.0)
    sd = jnp.sqrt(jnp.sum(((feats - mu) ** 2) * mask[:, None], 0)
                  / jnp.maximum(jnp.sum(mask), 1.0))
    feats = (feats - mu) / jnp.maximum(sd, 1e-12)
    model = estim_class_model(feats, NB_CLASSES_3D, 'GMM', sample_weight=mask,
                              seed=0)
    segm = pipelines.pipe_gray3d_slic_features_model_graphcut(
        vol, NB_CLASSES_3D, features, spacing=spacing, sp_size=sp_size,
        sp_regul=SP_REGUL_3D, gc_regul=GC_REGUL_3D)
    labels = np.asarray(labels)
    out = dict(_model_arrays(model),
               slic=labels[list(slices)].astype(np.int16),
               digest=segment_digest(labels, cfg.n_segments),
               slices=np.asarray(slices, np.int32),
               segm_bits=np.packbits(segm.astype(np.uint8).ravel()),
               shape=np.asarray(shape, np.int32),
               features=np.asarray(feats, np.float32),
               mask=np.asarray(mask, np.float32))
    print('3D %s: K %d, segm class shares %s' % (
        shape, cfg.n_segments, np.bincount(segm.ravel()) / segm.size))
    return {prefix + k: v for k, v in out.items()}


if __name__ == '__main__':
    main()
