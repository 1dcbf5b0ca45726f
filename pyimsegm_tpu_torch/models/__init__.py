"""Class models (unsupervised and supervised) of superpixel features."""

from pyimsegm_tpu_torch.models.class_model import (  # noqa: F401
    ClassModel,
    estim_class_model,
)
