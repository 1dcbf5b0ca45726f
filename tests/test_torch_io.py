"""The port's host I/O (``pyimsegm_tpu_torch.utils.data_io``, ``nifti``,
``read_zvi`` and the sample loaders of ``data_samples``) vs the JAX
package: image round trips through PIL (PNG, multi-frame TIFF), landmarks,
intensity scaling, folder matching, the object cut-out, NIfTI and ZVI
files read by both packages' readers, and the sample folder's path
resolution.  A ZVI file is built here from a seed: a minimal OLE2
compound file of 512-byte sectors with no mini stream."""

import importlib
import os
import struct

import numpy as np
import pytest

from pyimsegm_tpu.utils import data_io as jio
from pyimsegm_tpu.utils import data_samples as jsamples
from pyimsegm_tpu.utils import nifti as jnifti
from pyimsegm_tpu.utils import read_zvi as jzvi
from pyimsegm_tpu_torch.utils import data_io as tio
from pyimsegm_tpu_torch.utils import data_samples as tsamples
from pyimsegm_tpu_torch.utils import nifti as tnifti
from pyimsegm_tpu_torch.utils import read_zvi as tzvi
from pyimsegm_tpu_torch.utils.data_samples import sample_ovary_scene

from torch_threads import one_torch_thread  # noqa: F401


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _image(seed=0):
    img = sample_ovary_scene((40, 56), 2, rand_seed=seed)[0]
    return (img * 255).astype(np.uint8)


@pytest.mark.parametrize('kind', ['png_rgb', 'png_gray', 'tiff_volume',
                                  'tiff_stack'])
def test_image_round_trip(tmp_path, kind):
    img = _image()
    data = {'png_rgb': img, 'png_gray': img[..., 0],
            'tiff_volume': np.stack([img[..., c] for c in range(3)] * 2),
            'tiff_stack': np.stack([img[..., 0]] * 6)}[kind]
    ext = '.png' if kind.startswith('png') else '.tiff'
    path_t = str(tmp_path / ('t' + ext))
    path_j = str(tmp_path / ('j' + ext))
    tio.io_imsave(path_t, data)
    jio.io_imsave(path_j, data)
    _equal(tio.io_imread(path_t), data)
    _equal(jio.io_imread(path_t), tio.io_imread(path_j))
    _equal(tio.load_image_2d(path_t), jio.load_image_2d(path_t))
    _equal(tio.load_image(path_t, 1.0), jio.load_image(path_t, 1.0))
    if ext == '.tiff':
        _equal(tio.load_image_tiff_volume(path_t, 1.),
               jio.load_image_tiff_volume(path_t, 1.))
        _equal(tio.load_tiff_volume_split_double_band(path_t),
               jio.load_tiff_volume_split_double_band(path_t))
    _equal(tio.load_img_double_band_split(path_t),
           jio.load_img_double_band_split(path_t))


def test_export_and_folders(tmp_path):
    img = _image(1)
    for data in (img, img[..., 1], np.stack([img[..., 0]] * 5)):
        got = tio.export_image(str(tmp_path / 'out_t.x'), data)
        want = jio.export_image(str(tmp_path / 'out_j.x'), data)
        assert os.path.splitext(got)[1] == os.path.splitext(want)[1]
        _equal(tio.io_imread(got), jio.io_imread(want))
    assert tio.export_image(str(tmp_path / 'missing' / 'a.png'), img) == ''
    for d in ('imgs', 'segs'):
        os.makedirs(tmp_path / d)
        for i in (3, 1, 2):
            tio.io_imsave(str(tmp_path / d / ('%s_%d.png' % (d, i))), img)
    got = tio.load_complete_image_folder(str(tmp_path / 'imgs'), skip=['_2'])
    want = jio.load_complete_image_folder(str(tmp_path / 'imgs'),
                                          skip=['_2'])
    _equal(got[0], want[0])
    assert got[1] == want[1] == ['imgs_1', 'imgs_3']
    patterns = [str(tmp_path / 'imgs' / 'imgs_*.png'),
                str(tmp_path / 'segs' / 'segs_*.png')]
    got = tio.find_files_match_names_across_dirs(patterns)
    want = jio.find_files_match_names_across_dirs(patterns)
    assert got.values.tolist() == want.values.tolist() and len(got) == 3
    path = str(tmp_path / 'imgs' / 'imgs_1.png')
    tio.scale_image_size(path, (28, 20), str(tmp_path / 'small_t.png'))
    jio.scale_image_size(path, (28, 20), str(tmp_path / 'small_j.png'))
    _equal(tio.io_imread(str(tmp_path / 'small_t.png')),
           jio.io_imread(str(tmp_path / 'small_j.png')))


def test_landmarks_and_params(tmp_path):
    lnds = np.random.default_rng(0).integers(0, 500, (7, 2))
    for fmt in ('txt', 'csv'):
        save_t = getattr(tio, 'save_landmarks_' + fmt)
        path = save_t(str(tmp_path / 'lnd_t.x'), lnds)
        _equal(getattr(tio, 'load_landmarks_' + fmt)(path),
               getattr(jio, 'load_landmarks_' + fmt)(path))
        _equal(getattr(tio, 'load_landmarks_' + fmt)(path), lnds)
    _equal(tio.swap_coord_x_y(lnds), jio.swap_coord_x_y(lnds))
    path = str(tmp_path / 'params.txt')
    with open(path, 'w') as fp:
        fp.write('a : 1\nno colon\nname: x : y\n')
    assert tio.load_params_from_txt(path) == jio.load_params_from_txt(path)
    with pytest.raises(FileNotFoundError):
        tio.load_landmarks_txt(str(tmp_path / 'none.txt'))


def test_scaling_channels_and_crop():
    img = _image(2).astype(float)
    _equal(tio.scale_image_vals_in_range(img, 255),
           jio.scale_image_vals_in_range(img, 255))
    _equal(tio.scale_image_intensity(img, 255, (5, 95)),
           jio.scale_image_intensity(img, 255, (5, 95)))
    _equal(tio.merge_image_channels(img[..., 0], img[..., 1]),
           jio.merge_image_channels(img[..., 0], img[..., 1]))
    with pytest.raises(tio.ImageDimensionError):
        tio.merge_image_channels(img[..., 0], img[:-1, :, 1])
    segm = sample_ovary_scene((40, 56), 2, rand_seed=2)[1]
    for x in (segm, img):
        _equal(tio.get_image2d_boundary_color(x, 2),
               jio.get_image2d_boundary_color(x, 2))
    mask = segm == segm[20, 28]
    for kw in ({}, {'use_mask': True}, {'allow_rotate': False},
               {'use_mask': True, 'bg_color': 7}):
        _equal(tio.cut_object(img[..., 0], mask, 3, **kw),
               jio.cut_object(img[..., 0], mask, 3, **kw))
    assert tio.add_padding((50, 50), 5, 15, 25, 35, 55) == (10, 20, 40, 50)


@pytest.mark.parametrize('dtype', ['uint8', 'int16', 'float32', 'rgb'])
def test_nifti_both_readers(tmp_path, dtype):
    rng = np.random.default_rng(0)
    arr = (rng.integers(0, 255, (12, 9, 3)).astype(np.uint8) if dtype == 'rgb'
           else (rng.random((5, 7, 3)) * 100).astype(dtype))
    for writer, reader in ((tnifti, jnifti), (jnifti, tnifti)):
        for ext in ('.nii', '.nii.gz'):
            path = str(tmp_path / ('x' + ext))
            writer.save_nifti(path, arr)
            got = reader.load_nifti(path)
            assert got.dtype == arr.dtype
            _equal(got, arr)


def test_nifti_converters(tmp_path):
    img = _image(3)
    path = str(tmp_path / 'img.png')
    tio.io_imsave(path, img)
    for name in ('convert_img_2_nifti_gray', 'convert_img_2_nifti_rgb'):
        for mod, sub in ((tio, 't'), (jio, 'j')):
            os.makedirs(tmp_path / sub, exist_ok=True)
            getattr(mod, name)(path, str(tmp_path / sub))
        got = tnifti.load_nifti(str(tmp_path / 't' / 'img.nii'))
        want = jnifti.load_nifti(str(tmp_path / 'j' / 'img.nii'))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        tio.convert_nifti_2_img(str(tmp_path / 't' / 'img.nii'),
                                str(tmp_path / 'back_t.png'))
        jio.convert_nifti_2_img(str(tmp_path / 'j' / 'img.nii'),
                                str(tmp_path / 'back_j.png'))
        diff = np.abs(tio.io_imread(str(tmp_path / 'back_t.png')).astype(int)
                      - jio.io_imread(str(tmp_path / 'back_j.png')))
        assert diff.max() <= 1


def _cfb(streams):
    """An OLE2 compound file holding ``streams`` ({'A/B/C': bytes}), all
    in regular 512-byte sectors (a mini-stream cutoff of 0)."""
    end, free, nostream = 0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFF
    entries = [{'name': 'Root Entry', 'type': 5, 'children': []}]
    index = {(): 0}
    for path in streams:
        parts = tuple(path.split('/'))
        for d in range(1, len(parts) + 1):
            if parts[:d] not in index:
                index[parts[:d]] = len(entries)
                entries.append({'name': parts[d - 1], 'children': [],
                                'type': 2 if d == len(parts) else 1,
                                'data': streams[path] if d == len(parts)
                                else b''})
                entries[index[parts[:d - 1]]]['children'].append(
                    index[parts[:d]])
    n_dir = (len(entries) + 3) // 4
    sectors, fat = [], [0xFFFFFFFD]              # sector 0: the FAT
    chains = {}
    for i, e in enumerate(entries):
        data = e.get('data', b'')
        if data:
            n = (len(data) + 511) // 512
            start = 1 + n_dir + len(sectors)
            chains[i] = start
            sectors += [data[k * 512:(k + 1) * 512].ljust(512, b'\0')
                        for k in range(n)]
    fat += [2 + k if k < n_dir - 1 else end for k in range(n_dir)]
    for i, start in sorted(chains.items()):
        n = (len(entries[i]['data']) + 511) // 512
        fat += [start + k + 1 if k < n - 1 else end for k in range(n)]
    assert len(fat) <= 128
    fat += [free] * (128 - len(fat))
    dir_raw = b''
    for i, e in enumerate(entries):
        raw = bytearray(128)
        name = e['name'].encode('utf-16-le') + b'\0\0'
        raw[:len(name)] = name
        struct.pack_into('<H', raw, 64, len(name))
        raw[66] = e['type']
        # siblings chained to the right, a storage points at its first child
        sibs = next((p['children'] for p in entries if i in p['children']),
                    [i])
        pos = sibs.index(i)
        right = sibs[pos + 1] if pos + 1 < len(sibs) else nostream
        child = e['children'][0] if e['children'] else nostream
        struct.pack_into('<III', raw, 68, nostream, right, child)
        struct.pack_into('<I', raw, 116, chains.get(i, end))
        struct.pack_into('<Q', raw, 120, len(e.get('data', b'')))
        dir_raw += bytes(raw)
    dir_raw = dir_raw.ljust(n_dir * 512, b'\0')     # unused entries: zeros
    hdr = bytearray(512)
    hdr[:8] = b'\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1'
    struct.pack_into('<HHH', hdr, 24, 0x3E, 3, 0xFFFE)
    struct.pack_into('<HH', hdr, 30, 9, 6)
    struct.pack_into('<I', hdr, 44, 1)
    struct.pack_into('<I', hdr, 48, 1)
    struct.pack_into('<IIIII', hdr, 56, 0, end, 0, end, 0)
    struct.pack_into('<109I', hdr, 76, 0, *([free] * 108))
    fat_raw = struct.pack('<128I', *fat)
    return bytes(hdr) + fat_raw + dir_raw + b''.join(sectors)


def _zvi(planes):
    """ZVI streams of a (Z, H, W) uint16 stack (pixel format 4, 'Word')."""
    def i4(v):
        return struct.pack('<Hi', 3, v)

    def bstr(b):
        return struct.pack('<Hi', 8, len(b)) + b + (b'\0' * 4 if b else b'')

    def blob(b):
        return struct.pack('<Hi', 65, len(b)) + b

    z, h, w = planes.shape
    streams = {'Image/Contents': i4(1) + bstr(b'stack.zvi') + i4(w) + i4(h)
               + i4(1) + i4(4) + i4(z) + i4(16) + i4(0) + i4(0) + i4(0)
               + struct.pack('<Hh', 2, 1)}
    for k in range(z):
        body = (i4(1) + bstr(b'plane') + i4(w) + i4(h) + i4(1) + i4(4)
                + i4(z) + i4(16) + blob(b'others') + blob(b'') + blob(b'sc'))
        payload = struct.pack('<7i', 1, w, h, 1, 2, 4, 16) + planes[k].astype(
            '<u2').tobytes()
        streams['Image/Item(%d)/Contents' % k] = body + payload
    return _cfb(streams)


def test_zvi_both_readers(tmp_path):
    planes = np.random.default_rng(0).integers(0, 4096, (4, 10, 13)
                                               ).astype(np.uint16)
    path = str(tmp_path / 'stack.zvi')
    with open(path, 'wb') as fp:
        fp.write(_zvi(planes))
    assert tzvi.get_layer_count(path) == jzvi.get_layer_count(path) == 4
    _equal(tzvi.load_image(path), planes)
    _equal(tzvi.load_image(path), jzvi.load_image(path))
    assert tzvi.get_dir(path) == jzvi.get_dir(path)
    got, want = tzvi.zvi_read(path, 2), jzvi.zvi_read(path, 2)
    assert got[:-1] == want[:-1]
    _equal(got.Image.Array, want.Image.Array)
    _equal(tio.load_zvi_volume_double_band_split(path),
           jio.load_zvi_volume_double_band_split(path))
    _equal(tio.load_img_double_band_split(path, im_range=None),
           jio.load_img_double_band_split(path, im_range=None))
    data = b'\x03\x00\x05\x00\x00\x00' + b'\x08\x00\x02\x00\x00\x00ab\0\0\0\0'
    for t in ('I4', 'BSTR', 'NULL'):
        assert tzvi.read_struct(data, t) == jzvi.read_struct(data, t)
    assert tzvi.i32(data) == jzvi.i32(data)
    assert tzvi.get_hex(data, 8) == jzvi.get_hex(data, 8)


def test_sample_paths_follow_jax(tmp_path, monkeypatch):
    """With the sample folder set by ``PYIMSEGM_DATA_PATH``, the port and
    the JAX package resolve the same paths, agree that the samples are
    absent, and both refuse to load one; with a sample written there, both
    load it alike."""
    monkeypatch.setenv('PYIMSEGM_DATA_PATH', str(tmp_path))
    try:
        jmod = importlib.reload(jsamples)
        tmod = importlib.reload(tsamples)
        names = [n for n in dir(jmod) if n.startswith(('IMAGE_', 'ANNOT_'))]
        assert len(names) == 7
        for n in names + ['PATH_DATA_IMAGES']:
            assert getattr(tmod, n) == getattr(jmod, n)
        assert tmod.has_sample_data() is jmod.has_sample_data() is False
        for name in ('rel/a.png', '/abs/b.png'):
            assert tmod.get_image_path(name) == jmod.get_image_path(name)
            assert tmod.get_image_path(name, 'base') == \
                jmod.get_image_path(name, 'base')
        for fn in ('load_sample_image', 'load_sample_labels'):
            for mod in (tmod, jmod):
                with pytest.raises(FileNotFoundError):
                    getattr(mod, fn)()
        img = _image(4)
        for path in (tmod.IMAGE_DROSOPHILA_OVARY_2D,
                     tmod.ANNOT_DROSOPHILA_OVARY_2D):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        tio.io_imsave(tmod.ANNOT_DROSOPHILA_OVARY_2D, img[..., 0] // 64 * 60)
        tio.io_imsave(tmod.IMAGE_DROSOPHILA_OVARY_2D.replace('.jpg', '.png'),
                      img)
        os.rename(tmod.IMAGE_DROSOPHILA_OVARY_2D.replace('.jpg', '.png'),
                  tmod.IMAGE_DROSOPHILA_OVARY_2D)
        assert tmod.has_sample_data() and jmod.has_sample_data()
        _equal(tmod.load_sample_image(), jmod.load_sample_image())
        _equal(tmod.load_sample_labels(), jmod.load_sample_labels())
    finally:
        monkeypatch.undo()
        importlib.reload(jsamples)
        importlib.reload(tsamples)
