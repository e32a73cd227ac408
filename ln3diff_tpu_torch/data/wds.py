"""WebDataset-format shard IO in numpy, on the host.

The port's copy of ``ln3diff_tpu/data/wds.py`` (the reference's webdataset
pipelines, ``datasets/g_buffer_objaverse.py:3196-4583``
``load_wds_ResampledShard``, and the shard creator ``scripts/wds_create.py``):
shards are plain tar files whose members share a key prefix
(``{key}.{field}.{ext}``), read with the stdlib ``tarfile`` module or the
native threaded reader (``native/shard_loader.cpp``); npy/json/txt/npz
fields are decoded, grouped by key, transformed, shuffle-buffered and
batched in numpy, the same code as the JAX package's, so both make the
same batches in the same order.  The trainers' ``prepare_batch`` moves a
batch to the device.

Field encodings: ``.npy``, ``.json``, ``.txt``, ``.npz``, raw bytes
otherwise; ``.gz`` through the stdlib, ``.lz4`` when the lz4 package is
importable.

One difference: where the native reader cannot be built,
:func:`iter_shards_native` raises with the compiler's log; the JAX
package's reads through ``tarfile`` instead without a word.
"""

from __future__ import annotations

import gzip
import io
import json
import os
import tarfile
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

try:
    import lz4.frame as _lz4
except Exception:  # pragma: no cover
    _lz4 = None


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

class ShardWriter:
    """Write samples into tar shards with size-based rotation
    (reference ``scripts/wds_create.py``)."""

    def __init__(self, pattern: str, maxcount: int = 1000):
        self.pattern = pattern
        self.maxcount = maxcount
        self.shard_idx = 0
        self.count = 0
        self._tar: Optional[tarfile.TarFile] = None
        self.paths: list[str] = []

    def _open_next(self):
        if self._tar is not None:
            self._tar.close()
        path = self.pattern % self.shard_idx \
            if '%' in self.pattern else f'{self.pattern}-{self.shard_idx:06d}.tar'
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        self._tar = tarfile.open(path, 'w')
        self.paths.append(path)
        self.shard_idx += 1
        self.count = 0

    def write(self, key: str, sample: dict):
        if self._tar is None or self.count >= self.maxcount:
            self._open_next()
        for field, value in sample.items():
            data = encode_field(field, value)
            info = tarfile.TarInfo(f'{key}.{field}')
            info.size = len(data)
            self._tar.addfile(info, io.BytesIO(data))
        self.count += 1

    def close(self):
        if self._tar is not None:
            self._tar.close()
            self._tar = None


def encode_field(field: str, value) -> bytes:
    if field.endswith('.npy'):
        buf = io.BytesIO()
        np.save(buf, np.asarray(value))
        return buf.getvalue()
    if field.endswith('.json'):
        return json.dumps(value).encode()
    if field.endswith('.txt'):
        return str(value).encode()
    if isinstance(value, bytes):
        return value
    raise TypeError(f'cannot encode field {field!r} of type {type(value)}')


def decode_field(name: str, data: bytes):
    if name.endswith('.gz'):
        data = gzip.decompress(data)
        name = name[:-3]
    if name.endswith('.lz4'):
        assert _lz4 is not None, 'lz4 not available'
        data = _lz4.decompress(data)
        name = name[:-4]
    if name.endswith('.npy'):
        return np.load(io.BytesIO(data), allow_pickle=False)
    if name.endswith('.npz'):
        return dict(np.load(io.BytesIO(data), allow_pickle=False))
    if name.endswith('.json'):
        return json.loads(data.decode())
    if name.endswith('.txt'):
        return data.decode()
    return data


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def iter_shard(path: str) -> Iterator[dict]:
    """Yield grouped samples {field: decoded} from one tar shard."""
    with tarfile.open(path, 'r') as tar:
        current_key = None
        sample: dict = {}
        for member in tar:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            key, _, field = base.partition('.')
            data = tar.extractfile(member).read()
            if current_key is not None and key != current_key and sample:
                yield sample
                sample = {}
            current_key = key
            sample[field] = decode_field(field, data)
            sample['__key__'] = key
        if sample:
            yield sample


def iter_shards_native(paths: Sequence[str], loop: bool = False
                       ) -> Iterator[dict]:
    """Yield grouped samples across shards through the native threaded
    tar reader (``native/shard_loader.cpp``, built with g++ at first use;
    the DataLoader-worker analogue).  Raises when the reader cannot be
    built."""
    from ..native.build import NativeShardReader
    reader = NativeShardReader(list(paths), loop=loop)

    current_key = None
    sample: dict = {}
    for name, data in reader:
        base = os.path.basename(name)
        key, _, field = base.partition('.')
        if current_key is not None and key != current_key and sample:
            yield sample
            sample = {}
        current_key = key
        sample[field] = decode_field(field, data)
        sample['__key__'] = key
    if sample:
        yield sample


def resampled_shards(paths: Sequence[str], rng: np.random.Generator
                     ) -> Iterator[str]:
    """Infinite random shard sampling (reference ResampledShards)."""
    paths = list(paths)
    while True:
        yield paths[int(rng.integers(0, len(paths)))]


def shuffled(it: Iterator, bufsize: int, rng: np.random.Generator):
    buf: list = []
    for x in it:
        if len(buf) < bufsize:
            buf.append(x)
            continue
        i = int(rng.integers(0, bufsize))
        yield buf[i]
        buf[i] = x
    rng.shuffle(buf)
    yield from buf


def load_wds_data(paths: Sequence[str], batch_size: int,
                  transform: Optional[Callable[[dict], dict]] = None,
                  shuffle_buffer: int = 100, seed: int = 0,
                  infinite: bool = True, rank: int = None,
                  num_replicas: int = None) -> Iterator[dict]:
    """Shards → decoded samples → transform → shuffle → stacked batches
    (the reference ``load_wds_data:4283`` pipeline).

    Multi-host decorrelation (reference: per-rank wds workers resample
    shards with worker-seeded rngs): ``rank``/``num_replicas`` default
    to this process's rank and world size (``parallel.mesh.host_shard``).  The rank folds
    into the shard-resampling/shuffle rng, so hosts draw decorrelated
    infinite streams; in the finite (epoch) mode shards are additionally
    STRIDED per rank (``paths[rank::num_replicas]``) when there are
    enough shards, giving disjoint coverage."""
    from ..parallel.mesh import host_shard

    default_rank, default_replicas = host_shard()
    rank = default_rank if rank is None else rank
    num_replicas = default_replicas if num_replicas is None else num_replicas
    rng = np.random.default_rng([seed, rank])

    epoch_paths = list(paths)
    if not infinite and num_replicas > 1 and len(epoch_paths) >= num_replicas:
        epoch_paths = epoch_paths[rank::num_replicas]

    def samples():
        if infinite:
            for shard in resampled_shards(paths, rng):
                yield from iter_shard(shard)
        else:
            for shard in epoch_paths:
                yield from iter_shard(shard)

    def transformed():
        for s in samples():
            yield transform(s) if transform else s

    it = shuffled(transformed(), shuffle_buffer, rng) \
        if shuffle_buffer > 1 else transformed()

    batch: list = []
    for s in it:
        batch.append(s)
        if len(batch) == batch_size:
            yield collate(batch)
            batch = []


def collate(batch: list[dict]) -> dict:
    out = {}
    for k in batch[0]:
        if k == '__key__':
            out[k] = [b[k] for b in batch]
        else:
            vals = [np.asarray(b[k]) for b in batch]
            out[k] = np.stack(vals)
    return out
