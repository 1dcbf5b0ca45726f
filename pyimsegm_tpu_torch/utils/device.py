"""Where a call runs: a tensor input on its own device, a numpy input on
the ``device`` the caller names (``'cuda'`` by default)."""

import numpy as np
import torch


def as_tensor(x, device='cuda', dtype=None):
    """``x`` as a tensor: a tensor stays on its device, anything else is
    moved to ``device``.  Naming a CUDA device without a card raises; the
    plain path is asked for with ``device='cpu'``, never taken on its own."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device for device=%r; pass device="cpu" '
                           'to run the plain PyTorch path' % str(device))
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def host_array(x):
    """``x`` as a numpy array: a tensor is copied from its device."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


#: prefix of the stage ranges that ``tools/profile_torch_port.py`` reads
STAGE_PREFIX = 'pyimsegm:'


def stage_range(name):
    """A ``torch.profiler`` range named ``pyimsegm:<name>`` around one stage
    of a pipeline: a profiler run attributes the stage's host time and the
    device time of the kernels it launched to it; without a profiler it
    costs a few microseconds."""
    return torch.profiler.record_function(STAGE_PREFIX + name)
