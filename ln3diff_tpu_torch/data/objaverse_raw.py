"""Raw G-Objaverse g-buffer ingestion (EXR depth and normal, camera json,
Cap3D captions, real-image evaluation sets).

The port's copy of ``ln3diff_tpu/data/objaverse_raw.py``, the same numpy
code, of the reference raw readers in ``datasets/g_buffer_objaverse.py``:

  * ``read_dnormal`` (:1731): ``{idx}_nd.exr``, 4-channel normal and
    depth; depth (the alpha channel) is zeroed inside ``‖campos‖ − √3/2``
    (the renderer's near clip) and nearest-resized;
  * ``read_camera_matrix_single`` (:1779): the blender-convention c2w of
    the per-view ``{idx}.json`` (x/y/z/origin vectors);
  * ``get_intri`` (:1754): fx = fy = 1422.222 at the 1024² raw renders,
    scaled to the target resolution, optionally normalised (EG3D
    convention);
  * ``unity2blender_fix`` (:55): the g-buffer normal frame fix;
  * ``MultiViewObjaverseRaw`` (:1908 ``MultiViewObjverseDataset``): walks
    ``{instance}/{idx:05d}/{idx:05d}.{png,json,_nd.exr}`` trees and
    yields per-instance view stacks for shard creation;
  * ``Cap3DCaptions`` (:1934 ``text_captions_cap3d.json``);
  * ``RealDataset`` (:2531): a directory of pngs/jpgs for image→3D
    evaluation (alpha over white, [-1, 1] and the imagenet encoder feed).

EXR files go through the port's codec (``data/exr.py``); Pillow is
imported where an image is read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from .exr import read_exr

RAW_RENDER_RES = 1024
RAW_FOCAL = 1422.222


def get_intrinsics(h: int, w: Optional[int] = None,
                   normalize: bool = False) -> np.ndarray:
    """(3, 3) K for the fixed g-buffer camera at resolution h×w
    (reference ``get_intri``; ``normalize`` divides the first two rows
    by h — the EG3D 25-vector convention)."""
    w = w or h
    f = RAW_FOCAL * h / RAW_RENDER_RES
    K = np.array([f, 0, w / 2, 0, f, h / 2, 0, 0, 1], np.float64)
    if normalize:
        K[:6] /= h
    return K.reshape(3, 3)


def read_camera_matrix_single(json_file: str) -> np.ndarray:
    """Per-view camera json → (4, 4) blender-convention c2w."""
    with open(json_file, 'r', encoding='utf8') as f:
        content = json.load(f)
    c2w = np.eye(4)
    c2w[:3, 0] = np.array(content['x'])
    c2w[:3, 1] = np.array(content['y'])
    c2w[:3, 2] = np.array(content['z'])
    c2w[:3, 3] = np.array(content['origin'])
    return c2w


def camera_25d(c2w: np.ndarray, resolution: int) -> np.ndarray:
    """(25,) conditioning vector: flattened c2w + normalized K
    (reference ``__getitem__``: ``np.concatenate([c2w.reshape(16),
    self.intrinsics])``)."""
    K = get_intrinsics(resolution, normalize=True)
    return np.concatenate([c2w.reshape(16),
                           K.reshape(9)]).astype(np.float32)


def _nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = (np.arange(h) * (img.shape[0] / h)).astype(np.int64)
    xs = (np.arange(w) * (img.shape[1] / w)).astype(np.int64)
    return img[ys][:, xs]


def unity2blender_fix(normal: np.ndarray) -> np.ndarray:
    """G-buffer normal frame fix (reference :55)."""
    out = normal.copy()
    out[..., 0] = -normal[..., 0]
    out[..., 1] = -normal[..., 2]
    out[..., 2] = normal[..., 1]
    return out


def read_dnormal(normald_path: str, cond_pos: np.ndarray,
                 h: Optional[int] = None, w: Optional[int] = None):
    """``{idx}_nd.exr`` → (depth (h, w), normal (h, w, 3)).

    Depth (the file's 4th channel) is zeroed inside
    ``‖campos‖ − √3/2`` exactly like the reference; the normal comes
    back in the file's channel order with the blender fix applied.
    """
    chans = read_exr(normald_path)
    names = sorted(chans)
    # canonical layout: R/G/B normal + A distance; fall back to sorted
    # order with the last channel as depth for non-RGBA naming.
    if set('RGBA').issubset(chans):
        normal = np.stack([chans['R'], chans['G'], chans['B']], -1)
        depth = chans['A']
    else:
        normal = np.stack([chans[n] for n in names[:-1]], -1)
        depth = chans[names[-1]]
    depth = depth.copy()

    near_distance = float(np.linalg.norm(np.asarray(cond_pos).ravel())) \
        - 0.867           # sqrt(3)/2, reference read_dnormal
    depth[depth < near_distance] = 0.0
    if h is not None:
        assert w is not None
        depth = _nearest_resize(depth, h, w)
        normal = _nearest_resize(normal, h, w)
    return depth.astype(np.float32), unity2blender_fix(normal)


def load_bbox(mask: np.ndarray) -> np.ndarray:
    """Foreground bbox [top, left, height, width] (reference
    ``load_bbox:2093`` — 'height'/'width' are actually the max row/col
    indices; kept bit-for-bit)."""
    nz = np.nonzero(mask)
    if len(nz[0]) == 0:
        return np.zeros(4, np.float32)
    return np.array([nz[0].min(), nz[1].min(), nz[0].max(), nz[1].max()],
                    np.float32)


class Cap3DCaptions:
    """``text_captions_cap3d.json``: instance id → caption (reference
    :1934).  Ids are matched on the last two path components and on the
    bare leaf so both ``folder/uuid`` and ``uuid`` keys resolve."""

    def __init__(self, path: str):
        with open(path, 'r', encoding='utf8') as f:
            self._caps = json.load(f)

    def __call__(self, instance: str) -> str:
        parts = instance.strip('/').split('/')
        for key in ('/'.join(parts[-2:]), parts[-1]):
            if key in self._caps:
                return self._caps[key]
        return ''


def _load_png(path: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(path)
    if img.mode not in ('RGB', 'RGBA'):
        # grayscale / palette / CMYK inputs → RGBA so the downstream
        # channel logic (composite_rgba) always sees a channel axis
        img = img.convert('RGBA')
    return np.asarray(img)


def composite_rgba(raw: np.ndarray) -> np.ndarray:
    """RGBA uint8 → white-background RGB uint8 (reference :2615)."""
    if raw.shape[-1] == 4:
        alpha = raw[..., 3:4].astype(np.float32) / 255.0
        rgb = raw[..., :3].astype(np.float32) * alpha \
            + (1 - alpha) * 255.0
        return rgb.astype(np.uint8)
    return raw[..., :3]


@dataclasses.dataclass
class MultiViewObjaverseRaw:
    """Iterate raw g-buffer instances → shard-ready view stacks.

    root: directory of instance dirs, each holding per-view subdirs
    ``{idx:05d}/{idx:05d}.png + .json + _nd.exr``.
    Yields dicts with rgb (V, H, W, 3 f32 [0,1]), depth (V, H, W),
    alpha (V, H, W), c (V, 25), caption, ins — the schema
    ``scripts/wds_create.py`` packs (and ``PostProcess`` consumes).
    """
    root: str
    resolution: int = 256
    captions: Optional[Cap3DCaptions] = None
    view_ids: Optional[Sequence[int]] = None   # e.g. four_view [25,0,9,18]

    def instances(self):
        out = []
        for name in sorted(os.listdir(self.root)):
            p = os.path.join(self.root, name)
            if os.path.isdir(p):
                out.append(p)
        return out

    def _views(self, ins: str):
        if self.view_ids is not None:
            return [f'{i:05d}' for i in self.view_ids]
        return sorted(d for d in os.listdir(ins)
                      if os.path.isdir(os.path.join(ins, d)))

    def __iter__(self) -> Iterator[dict]:
        res = self.resolution
        for ins in self.instances():
            rgbs, depths, alphas, cs = [], [], [], []
            for v in self._views(ins):
                base = os.path.join(ins, v, v)
                c2w = read_camera_matrix_single(base + '.json')
                depth, _ = read_dnormal(base + '_nd.exr', c2w[:3, 3:],
                                        res, res)
                raw = _load_png(base + '.png')
                alpha = (depth > 0).astype(np.float32)
                rgb = composite_rgba(raw)
                if rgb.shape[0] != res:
                    from PIL import Image
                    rgb = np.asarray(Image.fromarray(rgb).resize(
                        (res, res), Image.LANCZOS))
                rgbs.append(rgb.astype(np.float32) / 255.0)
                depths.append(depth)
                alphas.append(alpha)
                cs.append(camera_25d(c2w, res))
            yield {
                'rgb': np.stack(rgbs),
                'depth': np.stack(depths),
                'alpha': np.stack(alphas),
                'c': np.stack(cs),
                'caption': self.captions(ins) if self.captions else '',
                'ins': os.path.basename(ins),
            }


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class RealDataset:
    """Directory of real pngs/jpgs → i23d evaluation feed (reference
    ``RealDataset:2531``): white-composited, Lanczos-resized, both the
    [-1, 1] target ``img`` and the imagenet-normalized encoder feed."""

    def __init__(self, file_path: str, reso: int, reso_encoder: int,
                 imgnet_normalize: bool = True):
        self.reso = reso
        self.reso_encoder = reso_encoder
        self.imgnet_normalize = imgnet_normalize
        self.rgb_list = sorted(
            os.path.join(file_path, f) for f in os.listdir(file_path)
            if f.rsplit('.', 1)[-1].lower() in ('png', 'jpg', 'jpeg'))

    def __len__(self):
        return len(self.rgb_list)

    def __getitem__(self, index: int) -> dict:
        from PIL import Image
        raw = _load_png(self.rgb_list[index])
        rgb = composite_rgba(raw)
        pil = Image.fromarray(rgb)
        img = np.asarray(pil.resize((self.reso, self.reso),
                                    Image.LANCZOS)).astype(np.float32)
        enc = np.asarray(pil.resize((self.reso_encoder, self.reso_encoder),
                                    Image.LANCZOS)).astype(np.float32)
        enc = enc / 255.0
        if self.imgnet_normalize:
            enc = (enc - IMAGENET_MEAN) / IMAGENET_STD
        else:
            enc = enc * 2.0 - 1.0
        return {'img': img / 127.5 - 1.0,
                'img_to_encoder': enc,
                'fname': self.rgb_list[index]}
