"""The reference's float32 precision, and the controls' lower ones."""

import contextlib

import torch

from portbench.reference.frozen.models import gmm

#: the precisions a reference runs in: the configurations' float32 with
#: TF32 off, and the two controls a configuration may name
MODES = ('float32', 'tf32', 'bfloat16')


@contextlib.contextmanager
def precision(mode='float32', device='cuda'):
    """Run the reference in ``mode``: 'float32' with TF32 off for matmuls
    and convolutions; 'tf32' with TF32 on for both, also inside the GMM
    fit, which otherwise forces full float32 itself; 'bfloat16' with the
    convolutions and matmuls in bfloat16 (autocast)."""
    if mode not in MODES:
        raise ValueError('unknown precision %r' % mode)
    tf32 = mode == 'tf32'
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision(), gmm.FULL_PRECISION)
    torch.set_float32_matmul_precision('high' if tf32 else 'highest')
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    gmm.FULL_PRECISION = not tf32
    try:
        with torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                            enabled=mode == 'bfloat16'):
            yield
    finally:
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        gmm.FULL_PRECISION = saved[3]


def rounder(mode):
    """The function a stage's float inputs pass through: rounded to
    bfloat16 and back in 'bfloat16' (the stage computes on bf16 values),
    unchanged otherwise."""
    if mode != 'bfloat16':
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(t.dtype)
