"""Batched pipelines (port of ``pyimsegm_tpu.parallel``).

One card: the batch is a loop over the leading dimension.  Multi-GPU
execution (``make_mesh``, ``distributed_gmm_em``, ``tiled``) comes with a
later slice (ROADMAP.md).
"""

from pyimsegm_tpu_torch.parallel.batch import segment_images_batch  # noqa: F401
