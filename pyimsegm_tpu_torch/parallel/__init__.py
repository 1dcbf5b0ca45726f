"""Batched and multi-card pipelines (port of ``pyimsegm_tpu.parallel``).

SPMD with one process per card over a 1D ``DeviceMesh``
(:func:`~pyimsegm_tpu_torch.parallel.batch.make_mesh`): a batch of images
split over the ranks (:mod:`~pyimsegm_tpu_torch.parallel.batch`, with the
distributed GMM-EM of the group model), or one large image split into
bands of pixel rows (:mod:`~pyimsegm_tpu_torch.parallel.tiled`).
"""

from pyimsegm_tpu_torch.parallel.batch import (  # noqa: F401
    make_mesh,
    segment_images_batch,
    distributed_gmm_em,
)
