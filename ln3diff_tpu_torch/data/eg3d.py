"""FFHQ / EG3D-style posed image-folder dataset.

The port's copy of ``ln3diff_tpu/data/eg3d.py`` (reference
``datasets/eg3d_dataset.py``: EG3D ``ImageFolderDataset`` and
``init_dataset_kwargs:35``): a directory or zip of images with a
``dataset.json`` mapping each file to its 25-dim camera label (16
cam2world, 9 intrinsics), for the FFHQ configuration's single-view faces.

Images come back HWC float32 in [-1, 1], labels float32 (25,).  The rank
of :func:`load_eg3d_data` defaults to this process's
(``parallel.mesh.host_shard``).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Optional

import numpy as np


def _is_image(fname: str) -> bool:
    return fname.lower().endswith(('.png', '.jpg', '.jpeg'))


class ImageFolderDataset:
    """Posed single-view image dataset (directory or ``.zip``).

    ``dataset.json`` format (EG3D convention):
    ``{"labels": [["img0000.png", [c0, ..., c24]], ...]}``.
    Files without a label entry get an identity camera.
    """

    def __init__(self, path: str, resolution: Optional[int] = None,
                 use_labels: bool = True):
        self.path = path
        self.resolution = resolution
        self.use_labels = use_labels
        self._zip = None
        if path.endswith('.zip'):
            self._zip = zipfile.ZipFile(path)
            names = self._zip.namelist()
        else:
            names = []
            for root, _dirs, files in os.walk(path):
                for f in files:
                    names.append(os.path.relpath(os.path.join(root, f),
                                                 path))
        self.files = sorted(n for n in names if _is_image(n))
        if not self.files:
            raise FileNotFoundError(f'no images under {path}')

        self.labels = {}
        meta = self._read('dataset.json')
        if meta is not None and use_labels:
            for fname, label in json.loads(meta).get('labels') or []:
                self.labels[fname] = np.asarray(label, dtype=np.float32)

    def _read(self, name: str) -> Optional[bytes]:
        if self._zip is not None:
            try:
                return self._zip.read(name)
            except KeyError:
                return None
        full = os.path.join(self.path, name)
        if not os.path.exists(full):
            return None
        with open(full, 'rb') as f:
            return f.read()

    def __len__(self):
        return len(self.files)

    @property
    def label_dim(self) -> int:
        return 25

    def _identity_camera(self) -> np.ndarray:
        c = np.zeros(25, dtype=np.float32)
        c[[0, 5, 10, 15]] = 1.0          # identity cam2world
        c[[16, 20, 24]] = 1.0            # identity intrinsics
        return c

    def __getitem__(self, idx: int) -> dict:
        import io

        from PIL import Image

        fname = self.files[idx]
        img = Image.open(io.BytesIO(self._read(fname))).convert('RGB')
        if self.resolution and img.size != (self.resolution,
                                            self.resolution):
            img = img.resize((self.resolution, self.resolution),
                             Image.LANCZOS)
        arr = np.asarray(img, dtype=np.float32) / 127.5 - 1.0
        c = self.labels.get(fname)
        if c is None:
            c = self._identity_camera()
        return {'img': arr, 'c': c}


def init_dataset_kwargs(data: str, resolution: Optional[int] = None) -> dict:
    """Reference ``eg3d_dataset.py:35`` — probe the path and return the
    constructor kwargs (+ inferred resolution)."""
    ds = ImageFolderDataset(data, resolution=resolution)
    sample = ds[0]
    return {
        'path': data,
        'resolution': resolution or sample['img'].shape[0],
        'use_labels': True,
        'num_items': len(ds),
        'label_dim': ds.label_dim,
    }


def load_eg3d_data(path: str, batch_size: int, resolution: int = 128,
                   seed: int = 0, rank: int = None, world_size: int = 1):
    """Infinite shuffled batch iterator over an EG3D image folder.
    ``rank`` defaults to this process's rank in the process group, so
    that ranks draw decorrelated streams (reference per-rank sampler
    semantics)."""
    from ..parallel.mesh import host_shard

    ds = ImageFolderDataset(path, resolution=resolution)
    rank = host_shard()[0] if rank is None else rank
    rng = np.random.default_rng([seed, rank])
    n = len(ds)
    while True:
        idx = rng.integers(0, n, size=batch_size)
        samples = [ds[int(i)] for i in idx]
        yield {
            'img': np.stack([s['img'] for s in samples]),
            'c': np.stack([s['c'] for s in samples]),
        }
