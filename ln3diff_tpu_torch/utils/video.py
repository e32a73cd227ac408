"""Dependency-free video containers for serving output.

Port of ``ln3diff_tpu/utils/video.py``.  The reference dumps orbit
renders as mp4 through ``imageio``/ffmpeg (reference
``nsr/train_util_diffusion.py:292-376``); these writers need no codec
library:

- ``save_video_avi``: motion-JPEG in a RIFF/AVI container, each frame a
  baseline JPEG (Pillow's encoder), the container plain struct packing;
- ``save_video_gif``: a palettised animated GIF (Pillow).

Pillow is imported when a frame is encoded, and its absence raises there.
Frames are (F, H, W, 3) arrays, float in [-1, 1] or uint8.
"""

from __future__ import annotations

import io
import struct

import numpy as np

__all__ = ['save_video_avi', 'save_video_gif', 'frames_to_uint8']


def frames_to_uint8(frames: np.ndarray) -> np.ndarray:
    """[-1, 1] float frames -> uint8 (no-op for uint8 input)."""
    frames = np.asarray(frames)
    if frames.dtype == np.uint8:
        return frames
    return ((np.clip(frames.astype(np.float32), -1.0, 1.0) + 1.0)
            * 127.5).round().astype(np.uint8)


def _jpeg_bytes(frame_u8: np.ndarray, quality: int) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame_u8).save(buf, format='JPEG', quality=quality)
    return buf.getvalue()


def save_video_avi(frames: np.ndarray, path: str, fps: int = 24,
                   quality: int = 92) -> str:
    """Write (F, H, W, 3) frames as a motion-JPEG AVI.

    The container layout is RIFF('AVI ') -> LIST('hdrl')[avih +
    LIST('strl')[strh + strf]] -> LIST('movi')['00dc' chunks] -> idx1.
    Only the index flag + frame index are needed for seekability.
    """
    frames = frames_to_uint8(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f'expected (F, H, W, 3), got {frames.shape}')
    n, h, w = frames.shape[:3]
    jpegs = [_jpeg_bytes(f, quality) for f in frames]
    max_size = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b'\x00' if len(payload) % 2 else b''
        return fourcc + struct.pack('<I', len(payload)) + payload + pad

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b'LIST', fourcc + payload)

    # --- headers -------------------------------------------------------
    AVIF_HASINDEX = 0x10
    avih = struct.pack(
        '<14I',
        1_000_000 // fps,            # dwMicroSecPerFrame
        max_size * fps,              # dwMaxBytesPerSec
        0,                           # dwPaddingGranularity
        AVIF_HASINDEX,               # dwFlags
        n,                           # dwTotalFrames
        0,                           # dwInitialFrames
        1,                           # dwStreams
        max_size,                    # dwSuggestedBufferSize
        w, h,
        0, 0, 0, 0)                  # dwReserved[4]
    strh = (b'vids' + b'MJPG' + struct.pack(
        '<IHHIIIIIIIi4H',
        0, 0, 0,                     # dwFlags, wPriority, wLanguage
        0,                           # dwInitialFrames
        1, fps,                      # dwScale, dwRate  (rate/scale = fps)
        0, n,                        # dwStart, dwLength (in frames)
        max_size,                    # dwSuggestedBufferSize
        0xFFFFFFFF, -1,              # dwQuality, dwSampleSize
        0, 0, w, h))                 # rcFrame
    strf = struct.pack(
        '<IiiHH4sIiiII',
        40, w, h, 1, 24,             # BITMAPINFOHEADER, biBitCount 24
        b'MJPG',
        w * h * 3,                   # biSizeImage (nominal)
        0, 0, 0, 0)
    hdrl = lst(b'hdrl', chunk(b'avih', avih)
               + lst(b'strl', chunk(b'strh', strh) + chunk(b'strf', strf)))

    # --- movi + idx1 ---------------------------------------------------
    movi_payload = b''
    index = b''
    offset = 4                       # index offsets count from 'movi'
    AVIIF_KEYFRAME = 0x10
    for j in jpegs:
        movi_payload += chunk(b'00dc', j)
        index += b'00dc' + struct.pack('<III', AVIIF_KEYFRAME, offset,
                                       len(j))
        offset += 8 + len(j) + (len(j) % 2)
    movi = lst(b'movi', movi_payload)
    idx1 = chunk(b'idx1', index)

    riff = chunk(b'RIFF', b'AVI ' + hdrl + movi + idx1)
    with open(path, 'wb') as f:
        f.write(riff)
    return path


def save_video_gif(frames: np.ndarray, path: str, fps: int = 24) -> str:
    """Write (F, H, W, 3) frames as an animated GIF (looping)."""
    from PIL import Image
    frames = frames_to_uint8(frames)
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=max(1, round(1000 / fps)), loop=0)
    return path
