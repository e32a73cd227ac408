"""G-Objaverse sample post-processing (numpy, host side).

The port's copy of ``ln3diff_tpu/data/objaverse.py`` (reference
``PostProcess``, ``datasets/g_buffer_objaverse.py:3196-3915``), the same
numpy code, so that both packages make the same arrays from the same
shard samples: camera rays and their Plücker embedding (``gen_rays:3272``,
plucker = [cross(o, d), d]), the PIL resize, [-1, 1] normalisation, the
depth channel, the paired held-out ``nv_*`` views and the
``frame_0_as_canonical`` pose canonicalisation; ``DiffPostProcess`` for
pre-extracted latent shards.  Pillow is imported where an image is
resized.  The batches stay numpy; the trainers' ``prepare_batch`` moves
them to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def rays_from_camera(c25: np.ndarray, resolution: int):
    """Pixel-centre rays (origins, dirs), each (H, W, 3), of a 25-dim
    camera (cam2world 4x4, then intrinsics 3x3 normalised by the image
    size), OpenCV convention."""
    c2w = c25[:16].reshape(4, 4)
    intr = c25[16:25].reshape(3, 3)
    fx, fy, cx, cy = intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2]
    yy, xx = np.meshgrid(
        (np.arange(resolution) + 0.5) / resolution,
        (np.arange(resolution) + 0.5) / resolution, indexing='ij')
    dirs = np.stack([(xx - cx) / fx, (yy - cy) / fy, np.ones_like(xx)],
                    axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs = dirs @ c2w[:3, :3].T
    origins = np.broadcast_to(c2w[:3, 3], dirs.shape)
    return origins.astype(np.float32), dirs.astype(np.float32)


def plucker_embedding(c25: np.ndarray, resolution: int) -> np.ndarray:
    """6-channel Plücker rays [cross(o, d), d], (H, W, 6) f32."""
    o, d = rays_from_camera(c25, resolution)
    return np.concatenate([np.cross(o, d), d], axis=-1).astype(np.float32)


def resize_image(img: np.ndarray, size: int) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) image to ``size``² with PIL: uint8
    RGB triples by LANCZOS, every other channel as f32 by BILINEAR."""
    from PIL import Image
    if img.shape[0] == size:
        return img
    mode = 'F' if img.ndim == 2 else None
    if img.ndim == 2:
        pil = Image.fromarray(img.astype(np.float32), mode='F')
        return np.asarray(pil.resize((size, size), Image.BILINEAR))
    out = []
    for ch in range(0, img.shape[-1], 3):
        sl = img[..., ch:ch + 3]
        if sl.shape[-1] == 3 and img.dtype == np.uint8:
            pil = Image.fromarray(sl)
            out.append(np.asarray(pil.resize((size, size), Image.LANCZOS)))
        else:
            for c in range(sl.shape[-1]):
                pil = Image.fromarray(sl[..., c].astype(np.float32),
                                      mode='F')
                out.append(np.asarray(pil.resize((size, size),
                                                 Image.BILINEAR))[..., None])
    return np.concatenate([o if o.ndim == 3 else o[..., None]
                           for o in out], axis=-1)


def canonicalize_poses(c25: np.ndarray, anchor_idx: int = 0) -> np.ndarray:
    """``frame_0_as_canonical``: express all cam2world in the anchor
    frame's coordinates (reference pose canonicalization)."""
    out = c25.copy()
    anchor = c25[anchor_idx, :16].reshape(4, 4)
    inv = np.linalg.inv(anchor)
    for i in range(c25.shape[0]):
        c2w = c25[i, :16].reshape(4, 4)
        out[i, :16] = (inv @ c2w).reshape(16)
    return out


@dataclasses.dataclass
class PostProcess:
    """Per-sample transform: raw G-buffer fields → trainer batch fields.

    Expects decoded shard fields: ``rgb.npy`` (V, H, W, 3 uint8 or float),
    ``depth.npy`` (V, H, W), ``c.npy`` (V, 25), optional ``alpha.npy``,
    ``caption.txt``.
    """
    reso_encoder: int = 256
    reso_render: int = 128
    num_views_input: int = 4          # V views into the encoder
    num_views_sup: int = 2            # paired held-out supervision views
    frame_0_as_canonical: bool = False
    append_depth: bool = True
    plucker: bool = True

    def _sup_fields(self, rgb, depth, alpha, c, views):
        imgs, depths, masks, cams, bboxes = ([] for _ in range(5))
        for v in views:
            imgs.append(resize_image(rgb[v], self.reso_render) * 2 - 1)
            depths.append(resize_image(depth[v], self.reso_render))
            m = resize_image(alpha[v].astype(np.float32), self.reso_render)
            masks.append(m)
            cams.append(c[v])
            ys, xs = np.nonzero(m > 0.5)
            if len(ys):
                bboxes.append([ys.min(), xs.min(), ys.max() + 1,
                               xs.max() + 1])
            else:
                bboxes.append([0, 0, self.reso_render, self.reso_render])
        return (np.stack(imgs).astype(np.float32),
                np.stack(depths).astype(np.float32),
                np.stack(masks).astype(np.float32),
                np.stack(cams).astype(np.float32),
                np.asarray(bboxes, np.int32))

    def __call__(self, sample: dict) -> dict:
        rgb = np.asarray(sample['rgb.npy'])
        depth = np.asarray(sample['depth.npy']).astype(np.float32)
        c = np.asarray(sample['c.npy']).astype(np.float32)
        V = rgb.shape[0]
        if rgb.dtype == np.uint8:
            rgb = rgb.astype(np.float32) / 255.0
        alpha = np.asarray(sample.get('alpha.npy',
                                      (depth > 1e-3).astype(np.float32)))

        if self.frame_0_as_canonical:
            c = canonicalize_poses(c)

        enc_views = list(range(min(self.num_views_input, V)))
        enc_inputs = []
        for v in enc_views:
            rgb_e = resize_image(rgb[v], self.reso_encoder)
            dep_e = resize_image(depth[v], self.reso_encoder)
            parts = [rgb_e * 2 - 1]
            if self.append_depth:
                parts.append(dep_e[..., None])
            if self.plucker:
                parts.append(plucker_embedding(c[v], self.reso_encoder))
            enc_inputs.append(np.concatenate(parts, -1).astype(np.float32))

        imgs, depths, masks, cams, bboxes = self._sup_fields(
            rgb, depth, alpha, c, enc_views)
        out = {
            'img_to_encoder': np.stack(enc_inputs),
            'img': imgs, 'depth': depths, 'depth_mask': masks,
            'c': cams, 'bbox': bboxes,
            'caption': sample.get('caption.txt', ''),
            '__key__': sample.get('__key__', ''),
        }

        # Paired held-out novel views (reference nv_* schema,
        # ``paired_post_process`` g_buffer_objaverse.py:3444+): supervise
        # views the encoder never saw.  Falls back to wrapping when the
        # sample has no spare views.
        if self.num_views_sup > 0:
            held_out = [v for v in range(V) if v not in enc_views]
            if not held_out:
                held_out = enc_views
            nv_views = [held_out[i % len(held_out)]
                        for i in range(self.num_views_sup)]
            (out['nv_img'], out['nv_depth'], out['nv_depth_mask'],
             out['nv_c'], out['nv_bbox']) = self._sup_fields(
                rgb, depth, alpha, c, nv_views)
        return out


@dataclasses.dataclass
class DiffPostProcess:
    """Pre-extracted-latent shards for stage-2 training (reference
    ``load_wds_diff_ResampledShard:3916``): fields ``latent.npy``
    (h, w, 12) and ``caption.txt`` (+ optional img/c for i23d)."""

    def __call__(self, sample: dict) -> dict:
        out = {'latent': np.asarray(sample['latent.npy'], np.float32),
               'caption': sample.get('caption.txt', '')}
        if 'img.npy' in sample:
            out['img'] = np.asarray(sample['img.npy'], np.float32)
        if 'c.npy' in sample:
            out['c'] = np.asarray(sample['c.npy'], np.float32)
        return out
