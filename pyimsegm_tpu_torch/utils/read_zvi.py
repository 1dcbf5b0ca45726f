"""Zeiss ZVI microscopy image reader, host Python (port of
``pyimsegm_tpu.utils.read_zvi``; no olefile dependency).

ZVI files are Microsoft OLE2 / Compound File Binary (MS-CFB) containers;
this module has its own minimal CFB reader (header, FAT / miniFAT chains,
directory tree) and parses the ``/Image/Item(n)/Contents`` streams: a
VARIANT-tagged header (version, filename, width, height, depth, pixel
format, ...) followed by the raw pixel payload (a 28-byte image header and
a uint16 plane).
"""

import struct
from collections import namedtuple

import numpy as np

_CFB_MAGIC = b'\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1'
_FREESECT = 0xFFFFFFFF
_ENDOFCHAIN = 0xFFFFFFFE
_NOSTREAM = 0xFFFFFFFF


class CompoundFile:
    """Minimal MS-CFB (OLE2) reader: lists streams and reads their bytes."""

    def __init__(self, path):
        with open(path, 'rb') as fp:
            self._data = fp.read()
        d = self._data
        if d[:8] != _CFB_MAGIC:
            raise ValueError('not an OLE2 compound file: %r' % path)
        (self._sector_shift,) = struct.unpack_from('<H', d, 30)
        (self._mini_shift,) = struct.unpack_from('<H', d, 32)
        (self._n_fat,) = struct.unpack_from('<I', d, 44)
        (self._first_dir,) = struct.unpack_from('<I', d, 48)
        (self._mini_cutoff,) = struct.unpack_from('<I', d, 56)
        (self._first_minifat,) = struct.unpack_from('<I', d, 60)
        (self._n_minifat,) = struct.unpack_from('<I', d, 64)
        (self._first_difat,) = struct.unpack_from('<I', d, 68)
        (self._n_difat,) = struct.unpack_from('<I', d, 72)
        self._ssize = 1 << self._sector_shift
        self._msize = 1 << self._mini_shift

        # DIFAT: first 109 entries live in the header, rest in DIFAT sectors
        difat = list(struct.unpack_from('<109I', d, 76))
        sect = self._first_difat
        for _ in range(self._n_difat):
            raw = self._sector(sect)
            entries = struct.unpack('<%iI' % (self._ssize // 4), raw)
            difat.extend(entries[:-1])
            sect = entries[-1]
        fat_sectors = [s for s in difat[:self._n_fat] if s != _FREESECT]

        fat = []
        for s in fat_sectors:
            fat.extend(struct.unpack('<%iI' % (self._ssize // 4),
                                     self._sector(s)))
        self._fat = fat

        # directory entries
        dir_raw = self._read_chain(self._first_dir)
        self._entries = []
        for off in range(0, len(dir_raw) - 127, 128):
            e = dir_raw[off:off + 128]
            (name_len,) = struct.unpack_from('<H', e, 64)
            name = e[:max(0, name_len - 2)].decode('utf-16-le', 'ignore')
            otype = e[66]
            left, right, child = struct.unpack_from('<III', e, 68)
            (start,) = struct.unpack_from('<I', e, 116)
            (size,) = struct.unpack_from('<Q', e, 120)
            if self._sector_shift == 9:
                size &= 0xFFFFFFFF
            self._entries.append({'name': name, 'type': otype, 'left': left,
                                  'right': right, 'child': child,
                                  'start': start, 'size': size})

        # mini FAT + mini stream (root entry's chain)
        minifat = []
        sect = self._first_minifat
        while sect not in (_ENDOFCHAIN, _FREESECT) and len(minifat) // (self._ssize // 4) < self._n_minifat:
            minifat.extend(struct.unpack('<%iI' % (self._ssize // 4),
                                         self._sector(sect)))
            sect = self._fat[sect]
        self._minifat = minifat
        root = self._entries[0]
        self._ministream = self._read_chain(root['start'])[:root['size']] \
            if root['start'] not in (_ENDOFCHAIN, _FREESECT) else b''

        # full path per entry via the directory tree
        self._paths = {}
        self._walk(self._entries[0]['child'], ())

    def _sector(self, n):
        off = 512 + n * self._ssize
        return self._data[off:off + self._ssize]

    def _read_chain(self, start):
        out, sect, guard = [], start, 0
        while sect not in (_ENDOFCHAIN, _FREESECT):
            out.append(self._sector(sect))
            sect = self._fat[sect]
            guard += 1
            if guard > len(self._fat) + 1:
                break
        return b''.join(out)

    def _read_mini_chain(self, start, size):
        out, sect, guard = [], start, 0
        while sect not in (_ENDOFCHAIN, _FREESECT):
            off = sect * self._msize
            out.append(self._ministream[off:off + self._msize])
            sect = self._minifat[sect]
            guard += 1
            if guard > len(self._minifat) + 1:
                break
        return b''.join(out)[:size]

    def _walk(self, idx, prefix):
        if idx == _NOSTREAM or idx >= len(self._entries):
            return
        e = self._entries[idx]
        self._walk(e['left'], prefix)
        path = prefix + (e['name'],)
        self._paths[path] = idx
        if e['type'] == 1:  # storage
            self._walk(e['child'], path)
        self._walk(e['right'], prefix)

    def listdir(self):
        return [list(p) for p, i in sorted(self._paths.items())
                if self._entries[i]['type'] == 2]

    def openstream(self, path):
        if isinstance(path, str):
            path = path.split('/')
        idx = self._paths.get(tuple(path))
        if idx is None:
            raise KeyError('stream not found: %r' % (path,))
        e = self._entries[idx]
        if e['size'] < self._mini_cutoff and e is not self._entries[0]:
            return _Stream(self._read_mini_chain(e['start'], e['size']))
        return _Stream(self._read_chain(e['start'])[:e['size']])


class _Stream:
    def __init__(self, data):
        self._data = data

    def read(self):
        return self._data


# ----------------------------------------------------------- ZVI parsing ---

ZviImageTuple = namedtuple(
    'ZviImageTuple', 'Version FileName Width Height Depth PIXEL_FORMAT Count'
    ' ValidBitsPerPixel m_PluginCLSID Others Layers Scaling')
ZviItemTuple = namedtuple(
    'ZviItemTuple', 'Version FileName Width Height Depth PIXEL_FORMAT Count'
    ' ValidBitsPerPixel Others Layers Scaling Image')
ImageTuple = namedtuple(
    'ImageTuple', 'Version Width Height Depth PixelWidth PIXEL_FORMAT'
    ' ValidBitsPerPixel Array')

#: pixel format id -> (bytes per pixel, name)
PIXEL_FORMAT = {
    1: (3, 'ByteBGR'), 2: (4, 'ByteBGRA'), 3: (1, 'Byte'), 4: (2, 'Word'),
    5: (4, 'Long'), 6: (4, 'Float'), 7: (8, 'Double'), 8: (6, 'WordBGR'),
    9: (4, 'LongBGR'),
}


class _Cursor:
    """VARIANT-tagged field reader over a ZVI stream body."""

    def __init__(self, data):
        self.data = data
        self.pos = 0

    def _skip_tag(self):
        self.pos += 2  # 16-bit VARIANT type tag

    def i2(self):
        self._skip_tag()
        (v,) = struct.unpack_from('<h', self.data, self.pos)
        self.pos += 2
        return v

    def i4(self):
        self._skip_tag()
        (v,) = struct.unpack_from('<i', self.data, self.pos)
        self.pos += 4
        return v

    def blob(self):
        self._skip_tag()
        (size,) = struct.unpack_from('<i', self.data, self.pos)
        self.pos += 4
        v = self.data[self.pos:self.pos + size]
        self.pos += size
        return v

    def bstr(self):
        self._skip_tag()
        (size,) = struct.unpack_from('<i', self.data, self.pos)
        self.pos += 4
        if size > 0:
            v = self.data[self.pos:self.pos + size]
            self.pos += size + 4
        else:
            v = b''
            self.pos += 4
        return v


def read_image_container_content(stream):
    """Parse the /Image/Contents container header."""
    cur = _Cursor(stream.read())
    return ZviImageTuple(
        cur.i4(), cur.bstr(), cur.i4(), cur.i4(), cur.i4(), cur.i4(),
        cur.i4(), cur.i4(), cur.i4(), cur.i4(), cur.i4(), cur.i2())


def parse_image(data):
    """Raw plane payload: 28-byte header + uint16 pixels."""
    version, width, height, depth, pixel_width, pixel_format, vbpp = \
        struct.unpack_from('<7i', data, 0)
    raw = np.frombuffer(data[28:], np.uint16)
    array = raw.reshape(height, width)
    return ImageTuple(version, width, height, depth, pixel_width,
                      pixel_format, vbpp, array)


def read_item_storage_content(stream):
    """Parse one /Image/Item(n)/Contents stream."""
    data = stream.read()
    cur = _Cursor(data)
    version = cur.i4()
    filename = cur.bstr()
    width = cur.i4()
    height = cur.i4()
    depth = cur.i4()
    pixel_format = cur.i4()
    count = cur.i4()
    vbpp = cur.i4()
    others = cur.blob()
    layers = cur.blob()
    scaling = cur.blob()
    offset = width * height * PIXEL_FORMAT[pixel_format][0] + 28
    image = parse_image(data[-offset:])
    return ZviItemTuple(version, filename, width, height, depth, pixel_format,
                        count, vbpp, others, layers, scaling, image)


def get_layer_count(file_name, ole=None):
    """Number of image planes in the ZVI stack."""
    ole = ole or CompoundFile(file_name)
    return read_image_container_content(
        ole.openstream(['Image', 'Contents'])).Count


def get_dir(file_name, ole=None):
    """Stream listing with sizes."""
    ole = ole or CompoundFile(file_name)
    return ['%10d %s' % (len(ole.openstream(s).read()), s)
            for s in ole.listdir()]


def zvi_read(fname, plane, ole=None):
    """One plane as a ZviItemTuple."""
    ole = ole or CompoundFile(fname)
    return read_item_storage_content(
        ole.openstream(['Image', 'Item(%d)' % plane, 'Contents']))


def load_image(path_img):
    """Whole ZVI stack as (Z, H, W) uint16."""
    ole = CompoundFile(path_img)
    nb = get_layer_count('', ole=ole)
    return np.array([zvi_read('', i, ole=ole).Image.Array for i in range(nb)])


# -------------------------- low-level parity helpers --

def i32(data):
    """int32 from the first 4 bytes (two little-endian int16 halves)."""
    low, high = struct.unpack('<hh', data[:4])
    return (high << 16) + low


def get_hex(data, n=16):
    """Hex dump of the first ``n`` bytes, '|'-separated."""
    return '|'.join('%02x' % b for b in bytes(data[:n]))


def read_struct(data, t):
    """Read one VARIANT-tagged field of type ``t`` from ``data``; returns
    (value, remaining bytes).  Types: '?'/'EMPTY'/'NULL' (skip), 'I2', 'I4',
    'BLOB', 'BSTR'."""
    next_data = data[2:]   # skip the 16-bit VARIANT type tag
    if t in ('?', 'EMPTY', 'NULL'):
        return None, next_data
    if t == 'I2':
        (v,) = struct.unpack_from('<h', next_data, 0)
        return v, next_data[2:]
    if t == 'I4':
        (v,) = struct.unpack_from('<i', next_data, 0)
        return v, next_data[4:]
    if t == 'BLOB':
        (size,) = struct.unpack_from('<i', next_data, 0)
        return next_data[4:4 + size], next_data[4 + size:]
    if t == 'BSTR':
        (size,) = struct.unpack_from('<i', next_data, 0)
        if size > 0:
            return next_data[4:4 + size], next_data[4 + size + 4:]
        return b'', next_data[4 + 4:]
    raise ValueError('unsupported VARIANT type: %r' % t)
