"""Minimal OpenEXR scanline codec (read and write), without dependencies.

The port's copy of ``ln3diff_tpu/data/exr.py``, the same code, so that
both packages decode a g-buffer file to the same arrays.  The raw
G-Objaverse renders store depth and normal as 4-channel float EXRs
(``{idx}_nd.exr``) that the reference reads with ``cv2.imread(...,
IMREAD_UNCHANGED)`` (``datasets/g_buffer_objaverse.py:1731``
``read_dnormal``).  The subset of EXR 2.0 those files use:

  * single-part scanline images, increasing line order;
  * compression NONE (0), ZIPS (2, 1 line/chunk) and ZIP (3, 16
    lines/chunk): zlib deflate over the EXR byte-interleave and delta
    predictor (OpenEXR ``ImfZip.cpp``);
  * channel types HALF (f16), FLOAT (f32), UINT (u32).

Tiles, deep data, multi-part files and PIZ/PXR24/B44/DWA compression are
out of scope and raise.  The writer emits those chunks for the shard
tools and the tests (synthetic g-buffer trees).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_CODES = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
                np.dtype(np.float32): 2}
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}


def _predictor_decode(data: bytes) -> bytes:
    """Inverse of the EXR zip transform: delta-decode, then interleave
    the two halves back into alternating bytes."""
    c = np.frombuffer(data, np.uint8).astype(np.int64)
    if len(c) == 0:
        return b''
    c[1:] -= 128
    b = (np.cumsum(c) % 256).astype(np.uint8)
    half = (len(b) + 1) // 2
    out = np.empty(len(b), np.uint8)
    out[0::2] = b[:half]
    out[1::2] = b[half:]
    return out.tobytes()


def _predictor_encode(data: bytes) -> bytes:
    """EXR zip transform: de-interleave even/odd bytes into halves, then
    delta-encode."""
    raw = np.frombuffer(data, np.uint8)
    if len(raw) == 0:
        return b''
    a = np.concatenate([raw[0::2], raw[1::2]]).astype(np.int64)
    d = np.empty(len(a), np.int64)
    d[0] = a[0]
    d[1:] = a[1:] - a[:-1] + 128
    return (d % 256).astype(np.uint8).tobytes()


def _read_attr_string(buf, pos):
    end = buf.index(b'\0', pos)
    return buf[pos:end].decode('latin-1'), end + 1


def read_exr(path: str) -> dict:
    """Read an EXR → dict of channel name → (H, W) float32 array.

    Channels keep their stored names ('R', 'G', 'B', 'A', ...); values
    are widened to f32 (HALF sources) or reinterpreted (UINT kept as
    float for uniformity — raw ints available via ``dtype`` metadata).
    """
    with open(path, 'rb') as f:
        buf = f.read()
    magic, version = struct.unpack_from('<ii', buf, 0)
    assert magic == _MAGIC, f'not an EXR file: {path}'
    assert version & 0x200 == 0, 'tiled EXR not supported'
    assert version & 0x1000 == 0, 'multi-part EXR not supported'

    pos = 8
    channels = []            # (name, dtype)
    compression = None
    data_window = None
    while True:
        name, pos = _read_attr_string(buf, pos)
        if not name:
            break
        atype, pos = _read_attr_string(buf, pos)
        size, = struct.unpack_from('<i', buf, pos)
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == 'channels':
            cp = 0
            while payload[cp] != 0:
                cname, cp = _read_attr_string(payload, cp)
                ptype, = struct.unpack_from('<i', payload, cp)
                cp += 16   # type + pLinear/reserved + x/y sampling
                channels.append((cname, np.dtype(_PIXEL_DTYPES[ptype])))
        elif name == 'compression':
            compression = payload[0]
        elif name == 'dataWindow':
            data_window = struct.unpack('<4i', payload)

    assert compression in _LINES_PER_CHUNK, \
        f'unsupported EXR compression {compression} (scanline NONE/ZIP only)'
    xmin, ymin, xmax, ymax = data_window
    W, H = xmax - xmin + 1, ymax - ymin + 1
    channels.sort(key=lambda c: c[0])       # EXR stores alphabetically
    lines = _LINES_PER_CHUNK[compression]
    n_chunks = -(-H // lines)
    offsets = struct.unpack_from(f'<{n_chunks}q', buf, pos)

    bytes_per_line = sum(np.dtype(d).itemsize for _, d in channels) * W
    out = {name: np.empty((H, W), np.float32) for name, _ in channels}
    for off in offsets:
        y, packed = struct.unpack_from('<ii', buf, off)
        raw = buf[off + 8:off + 8 + packed]
        n_lines = min(lines, ymax - y + 1)
        expect = bytes_per_line * n_lines
        if compression != 0 and packed < expect:
            raw = _predictor_decode(zlib.decompress(raw))
        data = np.frombuffer(raw, np.uint8)
        lp = 0
        for li in range(n_lines):
            for cname, dt in channels:
                n = W * dt.itemsize
                row = np.frombuffer(
                    data[lp:lp + n].tobytes(), dt).astype(np.float32)
                out[cname][y - ymin + li] = row
                lp += n
    return out


def write_exr(path: str, channels: dict, compression: int = 3):
    """Write (H, W) arrays as a scanline EXR.

    ``channels``: name → array; f16/f32/u32 kept, others cast to f32.
    ``compression``: 0 (NONE), 2 (ZIPS) or 3 (ZIP, default).
    """
    names = sorted(channels)
    arrs = []
    for n in names:
        a = np.asarray(channels[n])
        if a.dtype not in _PIXEL_CODES:
            a = a.astype(np.float32)
        arrs.append(a)
    H, W = arrs[0].shape
    assert all(a.shape == (H, W) for a in arrs)

    def attr(name, atype, payload):
        return (name.encode() + b'\0' + atype.encode() + b'\0'
                + struct.pack('<i', len(payload)) + payload)

    chlist = b''
    for n, a in zip(names, arrs):
        chlist += (n.encode() + b'\0'
                   + struct.pack('<i', _PIXEL_CODES[a.dtype])
                   + b'\0\0\0\0' + struct.pack('<ii', 1, 1))
    chlist += b'\0'
    box = struct.pack('<4i', 0, 0, W - 1, H - 1)
    header = (attr('channels', 'chlist', chlist)
              + attr('compression', 'compression',
                     struct.pack('<B', compression))
              + attr('dataWindow', 'box2i', box)
              + attr('displayWindow', 'box2i', box)
              + attr('lineOrder', 'lineOrder', b'\0')
              + attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
              + attr('screenWindowCenter', 'v2f',
                     struct.pack('<2f', 0.0, 0.0))
              + attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
              + b'\0')

    lines = _LINES_PER_CHUNK[compression]
    n_chunks = -(-H // lines)
    chunks = []
    for ci in range(n_chunks):
        y0 = ci * lines
        n_lines = min(lines, H - y0)
        parts = []
        for li in range(n_lines):
            for a in arrs:
                parts.append(a[y0 + li].tobytes())
        raw = b''.join(parts)
        if compression != 0:
            packed = zlib.compress(_predictor_encode(raw))
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        chunks.append((y0, packed))

    with open(path, 'wb') as f:
        f.write(struct.pack('<ii', _MAGIC, 2))
        f.write(header)
        table_pos = f.tell()
        data_pos = table_pos + 8 * n_chunks
        offs = []
        for y0, packed in chunks:
            offs.append(data_pos)
            data_pos += 8 + len(packed)
        f.write(struct.pack(f'<{n_chunks}q', *offs))
        for y0, packed in chunks:
            f.write(struct.pack('<ii', y0, len(packed)))
            f.write(packed)
