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
  (int16).

A file whose arrays are unchanged is not rewritten, so its bytes stay as
committed.  ``chip_smoke.py`` reads both on the GPU machine, which has no
JAX.

Run on the CPU (about two minutes)::

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture.npz')
OUT_CONN = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_conn.npz')
OUT_FIT = os.path.join(ROOT, 'tests', 'data', 'torch_port_fixture_fit.npz')
CROP = (884, 1200)
SP_SIZE, SP_REGUL, GC_REGUL, NB_CLASSES = 35, 0.2, 2.0, 3
FEATURES = {'color': ['mean', 'std', 'energy']}
FEATURES_FIT = {'color': ['mean', 'std', 'energy', 'median', 'meanGrad']}
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

    imgs = [sample_color_image_rand_segment(CROP, NB_CLASSES, rand_seed=s)[0]
            for s in (0, 1)]
    model, _ = pipelines.estim_model_classes_group(
        imgs, NB_CLASSES, FEATURES, sp_size=SP_SIZE, sp_regul=SP_REGUL)
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


if __name__ == '__main__':
    main()
