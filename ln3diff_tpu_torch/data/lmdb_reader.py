"""LMDB dataset readers (the ShapeNet/FFHQ path).

The port's copy of ``ln3diff_tpu/data/lmdb_reader.py`` (reference
``datasets/shapenet.py`` ``LMDBDataset*`` with ``decompress_array:892``,
``scripts/lmdb_create.py``): keys ``{idx}-{field}`` hold compressed numpy
buffers.  The lmdb package is optional and imported when the module is:
without it the LMDB classes raise and name it, and ``DirectoryDataset``
serves the same samples from a plain directory of ``.npy`` files.

Compression: gzip through the stdlib, lz4 when the lz4 package is
importable (the reference uses both).
"""

from __future__ import annotations

import gzip
import io
import os
from typing import Iterator

import numpy as np

from ..utils.misc import optional_import

_lmdb = optional_import('lmdb')
_lz4 = optional_import('lz4.frame')


def compress_array(arr: np.ndarray, method: str = 'gzip') -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    raw = buf.getvalue()
    if method == 'gzip':
        return gzip.compress(raw, compresslevel=1)
    if method == 'lz4':
        assert _lz4 is not None, 'lz4 unavailable'
        return _lz4.compress(raw)
    return raw


def decompress_array(data: bytes, method: str = 'gzip') -> np.ndarray:
    """reference ``decompress_array`` (``datasets/shapenet.py:892``)."""
    if method == 'gzip':
        data = gzip.decompress(data)
    elif method == 'lz4':
        assert _lz4 is not None, 'lz4 unavailable'
        data = _lz4.decompress(data)
    return np.load(io.BytesIO(data), allow_pickle=False)


class LMDBDataset:
    """Random-access LMDB multi-view dataset (requires the lmdb pkg)."""

    FIELDS = ('raw_img', 'img', 'depth', 'depth_mask', 'c', 'bbox', 'ins')

    def __init__(self, path: str, compress: str = 'gzip'):
        assert _lmdb is not None, (
            'lmdb package not installed — use DirectoryDataset or the wds '
            'pipeline instead')
        self.env = _lmdb.open(path, readonly=True, lock=False,
                              readahead=False, meminit=False)
        self.compress = compress
        with self.env.begin() as txn:
            length = txn.get(b'length')
            self.length = int(length.decode()) if length else 0

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int) -> dict:
        out = {}
        with self.env.begin() as txn:
            for f in self.FIELDS:
                data = txn.get(f'{idx}-{f}'.encode())
                if data is not None:
                    out[f] = decompress_array(data, self.compress)
        return out


class LMDBWriter:
    """Serialize raw renders into LMDB (reference scripts/lmdb_create.py)."""

    def __init__(self, path: str, map_size: int = 2**40,
                 compress: str = 'gzip'):
        assert _lmdb is not None, 'lmdb package not installed'
        self.env = _lmdb.open(path, map_size=map_size)
        self.compress = compress
        self.count = 0

    def write(self, sample: dict):
        with self.env.begin(write=True) as txn:
            for f, arr in sample.items():
                txn.put(f'{self.count}-{f}'.encode(),
                        compress_array(np.asarray(arr), self.compress))
            self.count += 1

    def close(self):
        with self.env.begin(write=True) as txn:
            txn.put(b'length', str(self.count).encode())
        self.env.close()


class DirectoryDataset:
    """LMDB-interface-compatible dataset over ``{idx:06d}-{field}.npy``
    files; the zero-dependency fallback."""

    FIELDS = LMDBDataset.FIELDS

    def __init__(self, path: str):
        self.path = path
        idxs = set()
        for fn in os.listdir(path):
            if fn.endswith('.npy') and '-' in fn:
                idxs.add(int(fn.split('-')[0]))
        self.indices = sorted(idxs)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int) -> dict:
        idx = self.indices[i]
        out = {}
        for f in self.FIELDS:
            p = os.path.join(self.path, f'{idx:06d}-{f}.npy')
            if os.path.exists(p):
                out[f] = np.load(p)
        return out

    @staticmethod
    def write(path: str, samples: Iterator[dict]):
        os.makedirs(path, exist_ok=True)
        for i, sample in enumerate(samples):
            for f, arr in sample.items():
                np.save(os.path.join(path, f'{i:06d}-{f}.npy'),
                        np.asarray(arr))


def load_data(dataset, batch_size: int, rank: int = None,
              num_replicas: int = None, seed: int = 0,
              transform=None) -> Iterator[dict]:
    """Infinite shuffled batches over a random-access dataset (the role of
    reference ``load_data``, ``datasets/shapenet.py``).

    ``rank``/``num_replicas`` default to this process's rank and world
    size (``parallel.mesh.host_shard``), so ranks get DISJOINT index
    streams without callers plumbing ranks (reference
    ``InfiniteSampler(rank, num_replicas)``,
    ``utils/torch_utils/misc.py:140-160``)."""
    from ..parallel.mesh import host_shard
    from ..utils.misc import InfiniteSampler
    from .wds import collate

    default_rank, default_replicas = host_shard()
    rank = default_rank if rank is None else rank
    num_replicas = default_replicas if num_replicas is None else num_replicas
    sampler = iter(InfiniteSampler(len(dataset), rank, num_replicas,
                                   seed=seed))
    while True:
        samples = []
        for _ in range(batch_size):
            s = dataset[next(sampler)]
            samples.append(transform(s) if transform else s)
        yield collate(samples)
