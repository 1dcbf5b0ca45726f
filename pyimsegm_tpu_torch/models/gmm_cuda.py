"""The GMM fit's products over the samples on the card: one call into
``csrc/gmm_em.cu`` each (one CUDA kernel, two in the split mode).

:func:`weighted_sums` is ``w.transpose(-1, -2) @ x`` (EM's first moments,
k-means' weighted sums) and :func:`centred_sums` is ``((x - mu) *
w).transpose(-1, -2) @ (x - mu)`` (EM's centred second moments), the
products of ``models/gmm._weighted_sums_plain`` and
``models/gmm._centred_sums_plain``.  Each output is a chain of fused
multiply-adds in sample order from 0.  For a batch of restarts that is the
order of the kernel cuBLAS runs these products with on an H100
(``...tilesize32x32x8_stage3_warpsize1x2x1_ffma``), checked bit for bit at
the two benchmark fits' shapes, (N, D, C, R) = (107,328, 3, 2, 9) and
(57,600, 9, 3, 9) (``chip_smoke.py`` phase 17 asserts that cuBLAS still
picks that kernel there); at other shapes the kernel is within rounding of
the plain product, not bit for bit.  Unbatched weights (N, C), one fit's,
give :func:`weighted_sums` the split mode: a chain over each chunk of
``SPLIT`` samples, one block a chunk, the chunks' sums then added in order
in float64.  cuBLAS runs that product unbatched as a split-K GEMM, not as
one chain, and one chain of N samples on one block is both slower than it
and further from the exact sum (``PERF.md`` section 6, row 17).  A
restart whose ``active`` flag is False does no work and gets 0.  The
kernel replaces no TPU kernel: the JAX package leaves EM to XLA.

Routing rule (:func:`fits`, read by ``models/gmm.py``): float32 CUDA
samples ``x`` (N, D) and weights ``w`` (R, N, C), or (N, C) for one
unbatched fit, take the kernel when N >= 1, 1 <= D <= ``MAX_D`` (32) and
1 <= C <= ``MAX_C`` (8) components, the shapes of the kernel's
shared-memory and register plan.  Anything else takes the plain products:
a CPU tensor, float64 (the refit), a larger shape.
"""

import functools

import torch

from pyimsegm_tpu_torch import _build

MAX_D, MAX_C = 32, 8
#: samples a chunk of the split mode (a multiple of the kernel's tiles)
SPLIT = 1024
#: chunks a launch at most (the grid's second dimension)
_MAX_CHUNKS = 65535
#: kernel launches in this process, per wrapper
LAUNCHES = {'weighted_sums': 0, 'centred_sums': 0}


@functools.cache
def _lib():
    v, i = _build.VOIDP, _build.INT
    return _build.load('gmm_em', {
        'gmm_weighted_sums': [v] * 4 + [i] * 5 + [v] * 2,
        'gmm_centred_sums': [v] * 5 + [i] * 4 + [v],
    })


def shape_fits(n, d, c, r):
    """The kernel's shapes: N >= 1 samples of 1 <= D <= ``MAX_D`` features,
    1 <= C <= ``MAX_C`` components, R >= 1 restarts."""
    return n >= 1 and 1 <= d <= MAX_D and 1 <= c <= MAX_C and r >= 1


def fits(x, w):
    """True where the products of ``x`` (N, D) and the weights ``w`` (R, N,
    C) or (N, C) take the kernel: both float32 on a CUDA device, and a
    shape of :func:`shape_fits`."""
    return (x.is_cuda and x.dtype == torch.float32 and x.dim() == 2
            and w.dtype == torch.float32 and w.dim() in (2, 3)
            and shape_fits(x.shape[0], x.shape[1], w.shape[-1],
                           w.shape[0] if w.dim() == 3 else 1))


def _operand(t, name, shape):
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape``."""
    if t.dtype != torch.float32:
        raise ValueError('%s must be torch.float32, got %s' % (name, t.dtype))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % name)
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s must have shape %s, got %s'
                         % (name, tuple(shape), tuple(t.shape)))


def _check(x, w, active, mu=None):
    """Raise on what the kernel does not take, in this order: an operand
    that is not float32 (``active``: bool), not contiguous or of another
    shape, a shape outside :func:`shape_fits`, an operand off the card or
    off ``x``'s device.  Returns (N, D, C, R)."""
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError('x must be (N, D) and w (R, N, C), got %s and %s'
                         % (tuple(x.shape), tuple(w.shape)))
    (n, d), (r, _, c) = x.shape, w.shape
    _operand(x, 'x', (n, d))
    _operand(w, 'w', (r, n, c))
    if mu is not None:
        _operand(mu, 'mu', (r, c, d))
    if active is not None and (active.dtype != torch.bool
                               or tuple(active.shape) != (r,)
                               or not active.is_contiguous()):
        raise ValueError('active must be a contiguous (%d,) bool tensor' % r)
    if not shape_fits(n, d, c, r):
        raise ValueError('the kernel takes N >= 1, 1 <= D <= %d, '
                         '1 <= C <= %d and R >= 1; got N=%d, D=%d, C=%d, '
                         'R=%d' % (MAX_D, MAX_C, n, d, c, r))
    for name, t in (('x', x), ('w', w), ('mu', mu), ('active', active)):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError('%s must be a CUDA tensor' % name)
        if t.device != x.device:
            raise ValueError('%s must be on the device of x' % name)
    return n, d, c, r


def _ptr(t):
    return None if t is None else t.data_ptr()


def _unbatched(w, active, *more):
    """``w`` (N, C) and ``active`` () of one fit as a batch of one
    restart, with each of ``more`` given a leading 1."""
    return (w[None], None if active is None else active.reshape(1),
            *[t[None] for t in more])


def weighted_sums(w, x, active=None):
    """(R, C, D) sums over the samples of ``w`` (R, N, C) times ``x`` (N,
    D), as ``w.transpose(-1, -2) @ x``; 0 for a restart whose ``active``
    (R,) is False.  ``w`` (N, C) and ``active`` () give (C, D), summed in
    the split mode."""
    if w.dim() == 2:
        w, active = _unbatched(w, active)
        return _launch_weighted(w, x, active, True)[0]
    return _launch_weighted(w, x, active, False)


def _launch_weighted(w, x, active, split):
    """:func:`weighted_sums` of (R, N, C) weights, in chunks of ``SPLIT``
    samples (more where N needs more than ``_MAX_CHUNKS``) where ``split``."""
    n, d, c, r = _check(x, w, active)
    out = torch.empty((r, c, d), dtype=torch.float32, device=x.device)
    chunk, work = 0, None
    if split:
        chunk = SPLIT * -(-n // (SPLIT * _MAX_CHUNKS))
        work = torch.empty((-(-n // chunk), r, c, d), dtype=torch.float32,
                           device=x.device)
    _build.launch(_lib().gmm_weighted_sums, 'gmm_weighted_sums', x,
                  x.data_ptr(), w.data_ptr(), _ptr(active), out.data_ptr(),
                  n, d, c, r, chunk, _ptr(work))
    LAUNCHES['weighted_sums'] += 1
    return out


def centred_sums(x, w, mu, active=None):
    """(R, C, D, D) sums over the samples of ``(x - mu) * w`` times ``x -
    mu`` for each restart and component (``mu`` (R, C, D), ``w`` (R, N,
    C)), as ``((x - mu) * w).transpose(-1, -2) @ (x - mu)``; 0 for a
    restart whose ``active`` (R,) is False.  ``w`` (N, C), ``mu`` (C, D)
    and ``active`` () give (C, D, D)."""
    if w.dim() == 2:
        w, active, mu = _unbatched(w, active, mu)
        return centred_sums(x, w, mu, active)[0]
    n, d, c, r = _check(x, w, active, mu)
    out = torch.empty((r, c, d, d), dtype=torch.float32, device=x.device)
    _build.launch(_lib().gmm_centred_sums, 'gmm_centred_sums', x,
                  x.data_ptr(), w.data_ptr(), mu.data_ptr(), _ptr(active),
                  out.data_ptr(), n, d, c, r)
    LAUNCHES['centred_sums'] += 1
    return out
