"""The texture filter bank's battery maxima on the card: one launch of
``csrc/filter_bank.cu`` for the whole bank.

:func:`filter_bank` launches the kernel for a CUDA tensor and runs the
plain twin ``filters._filter_bank_raw_plain`` (one ``F.conv2d`` a battery)
for a CPU tensor.  The kernel replaces no TPU kernel: the JAX package
leaves the bank to ``lax.conv``.

The host lays the bank out for the kernel (:func:`pack_bank`): the bank's
batteries become passes of at most 8 filters, each with its flipped taps
as ``[ky][kx][group][4]`` (four filters a 16-byte group, padding zero) and
one row of the pass table.  A battery of 5 to 8 filters is one pass (5 and
7 padded to 6 and 8), a wider one several, each later pass merging its
maximum with the stored one; consecutive batteries of at most 4 filters
share a pass while it holds at most 4 (an LM sigma's Gaussian, LoG and
LoG2).  The widest pass picks the kernel's template instance.  The packed
taps and table are uploaded once per bank and device and kept while the
bank's kernels array lives (:data:`_DEVICE_BANKS`).
"""

import functools
import weakref
from typing import NamedTuple

import numpy as np
import torch

from pyimsegm_tpu_torch import _build
from pyimsegm_tpu_torch.ops import filters
from pyimsegm_tpu_torch.utils.device import count

#: output tile (rows, columns) of a block, and the largest support the
#: kernel takes (FB_TH, FB_TW, FB_MAX_SUPPORT of csrc/filter_bank.cu)
TILE_H, TILE_W = 32, 64
MAX_SUPPORT = 33
#: filters of a pass, by template instance of ``run_pass``
PASS_WIDTHS = (1, 2, 3, 4, 6, 8)
#: ints of a pass table row (FB_ENTRY): tap offset (float4s), filters,
#: float4 groups a tap, first battery, batteries, merge, then each filter's
#: battery from the first (-1: padding)
ENTRY = 14
#: launches of the CUDA kernel in this process
LAUNCHES = 0
#: {(id(kernels), battery_slices, device): (taps, table, wide)}: a bank's
#: packed taps and table on a device, as long as its kernels array lives
_DEVICE_BANKS = {}


class PackedBank(NamedTuple):
    """The bank as the kernel reads it."""
    taps: np.ndarray       # (n_groups, 4) float32, pass by pass
    table: np.ndarray      # (n_pass, ENTRY) int32
    wide: int              # float4 groups of the widest pass: 1 or 2


@functools.cache
def _lib():
    v, i, f = _build.VOIDP, _build.INT, _build.FLOAT
    return _build.load('filter_bank', {'filter_bank': [v] * 4 + [i] * 8
                                       + [f, v]})


def _passes(battery_slices):
    """[(filter indices, their battery from the first, first battery,
    batteries, merge)] in battery order."""
    out, small = [], None
    for bi, (start, stop) in enumerate(battery_slices):
        n = stop - start
        if n < 1:
            raise ValueError('battery %d has no filter' % bi)
        if n <= 4:
            if small is not None and len(small[0]) + n <= 4:
                small[0].extend(range(start, stop))
                small[1].extend([small[3]] * n)
                small[3] += 1
                continue
            if small is not None:
                out.append(tuple(small) + (False,))
            small = [list(range(start, stop)), [0] * n, bi, 1]
            continue
        if small is not None:
            out.append(tuple(small) + (False,))
            small = None
        for k, s in enumerate(range(start, stop, 8)):
            idx = list(range(s, min(s + 8, stop)))
            out.append((idx, [0] * len(idx), bi, 1, k > 0))
    if small is not None:
        out.append(tuple(small) + (False,))
    return out


def pack_bank(bank):
    """The flipped taps, the pass table and the template instance of
    ``bank`` (a ``filters.FilterBank``)."""
    kernels = np.asarray(bank.kernels, dtype=np.float32)
    support = kernels.shape[-1]
    flipped = kernels[:, ::-1, ::-1]
    taps, rows, off = [], [], 0
    for idx, fb, bat0, nbat, merge in _passes(bank.battery_slices):
        nf = min(w for w in PASS_WIDTHS if w >= len(idx))
        ng = (nf + 3) // 4
        block = np.zeros((support, support, 4 * ng), np.float32)
        block[..., :len(idx)] = np.moveaxis(flipped[idx], 0, -1)
        taps.append(block.reshape(-1, 4))
        row = np.zeros(ENTRY, np.int32)
        row[:6] = off, nf, ng, bat0, nbat, merge
        row[6:] = -1
        row[6:6 + len(fb)] = fb
        rows.append(row)
        off += support * support * ng
    table = np.stack(rows)
    return PackedBank(np.concatenate(taps), table, int(table[:, 2].max()))


def grid_dims(h, w, c):
    """The launch grid: (column tiles, row tiles, channels)."""
    return -(-w // TILE_W), -(-h // TILE_H), c


def _check_inputs(image, bank):
    """Raise on what the kernel does not take: an image that is not a
    contiguous (H, W, C) float32 CUDA tensor, a support that is even or
    above ``MAX_SUPPORT``, a battery with no filter."""
    _build.require(image, 'image', torch.float32)
    if image.dim() != 3:
        raise ValueError('image must be (H, W, C), got %s'
                         % (tuple(image.shape),))
    support = np.shape(bank.kernels)[-1]
    if support % 2 == 0 or support > MAX_SUPPORT:
        raise ValueError('the kernel takes odd supports up to %d, got %d'
                         % (MAX_SUPPORT, support))
    if any(stop <= start for start, stop in bank.battery_slices):
        raise ValueError('every battery needs a filter')


def _device_bank(bank, device):
    """(taps, table, wide) of ``bank`` on ``device``, packed and uploaded
    at the first call; the entry goes when the bank's kernels are freed."""
    key = (id(bank.kernels), bank.battery_slices, device)
    hit = _DEVICE_BANKS.get(key)
    if hit is None:
        packed = pack_bank(bank)
        hit = (torch.as_tensor(packed.taps, device=device),
               torch.as_tensor(packed.table, device=device), packed.wide)
        _DEVICE_BANKS[key] = hit
        weakref.finalize(bank.kernels, _DEVICE_BANKS.pop, key, None)
    return hit


def filter_bank(image, bank):
    """Orientation maxima of the bank's responses on every channel, clamped
    at ``filters.MAX_SIGNAL_RESPONSE``: (n_batteries, H, W, C) float32.

    :param image: (H, W, C) float32 tensor, contiguous on the card
    """
    if not image.is_cuda:
        return filters._filter_bank_raw_plain(image, bank)
    global LAUNCHES
    _check_inputs(image, bank)
    h, w, c = image.shape
    taps, table, wide = _device_bank(bank, image.device)
    out = torch.empty((len(bank.battery_slices), h, w, c),
                      dtype=torch.float32, device=image.device)
    gx, gy, _ = grid_dims(h, w, c)
    _build.launch(_lib().filter_bank, 'filter_bank', image,
                  image.data_ptr(), taps.data_ptr(), table.data_ptr(),
                  out.data_ptr(), h, w, c, np.shape(bank.kernels)[-1],
                  table.shape[0], wide, gx, gy,
                  float(filters.MAX_SIGNAL_RESPONSE))
    LAUNCHES += 1
    count('filter_bank_launches')
    return out
