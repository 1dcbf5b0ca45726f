"""PyTorch + CUDA port of pyimsegm-tpu.

The module paths and public names mirror ``pyimsegm_tpu``.  Plain tensor
code is PyTorch; the pixel-scale kernels of the main path are CUDA C++ for
Hopper (``csrc/*.cu``), built with ``nvcc`` at first use
(:mod:`pyimsegm_tpu_torch._build`).  A wrapper launches its kernel for a
CUDA tensor and runs its plain PyTorch twin for a CPU tensor.

The reference forces full-f32 matmuls on its small model and MRF products,
so TF32 is switched off for both matmuls and convolutions.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = '0.1.0'
