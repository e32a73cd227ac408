"""Serialize posed multi-view renders into an LMDB shard (or a directory).

Port of ``scripts/lmdb_create.py`` (reference ``scripts/lmdb_create.py``:
the compressed-array LMDB of the ShapeNet/FFHQ datasets,
``datasets/shapenet.py:892`` ``decompress_array``), the same parser: each
sample stores RGB, depth, foreground mask, the 25-dim camera and the
instance index, each array gzip/lz4-compressed.  Without ``--raw_dir`` it
writes synthetic scenes; without the lmdb package ``--format auto``
writes a ``DirectoryDataset``:

    python -m ln3diff_tpu_torch.scripts.lmdb_create --out DIR --num_instances 8
    python -m ln3diff_tpu_torch.scripts.lmdb_create --out DIR --raw_dir NPZ_DIR

Runs on the host; no card is needed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def synthetic_samples(num_instances: int, num_views: int, resolution: int,
                      seed: int = 0):
    from ..data.synthetic import make_multiview_batch
    for i in range(num_instances):
        batch = make_multiview_batch(num_views=num_views,
                                     resolution=resolution,
                                     seed=seed + i)
        yield {
            'raw_img': np.asarray(batch['img'], dtype=np.float32),
            'depth': np.asarray(batch['depth'], dtype=np.float32),
            'depth_mask': np.asarray(batch['depth_mask'], dtype=np.float32),
            'c': np.asarray(batch['c'], dtype=np.float32),
            'ins': np.asarray([i], dtype=np.int64),
        }


def directory_samples(raw_dir: str):
    """Read ``<raw_dir>/*.npz`` dumps (img/depth/mask/c)."""
    for name in sorted(os.listdir(raw_dir)):
        path = os.path.join(raw_dir, name)
        if not name.endswith('.npz'):
            continue
        with np.load(path) as z:
            yield {k: z[k] for k in z.files}


def main(argv=None) -> tuple:
    """Write the dataset; returns (instances written, 'lmdb' or
    'directory')."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--out', default='/tmp/ln3diff-lmdb')
    parser.add_argument('--raw_dir', default='',
                        help='directory of .npz multi-view dumps; '
                             'empty → synthetic scenes')
    parser.add_argument('--num_instances', type=int, default=8)
    parser.add_argument('--num_views', type=int, default=4)
    parser.add_argument('--resolution', type=int, default=128)
    parser.add_argument('--compress', default='gzip',
                        choices=['gzip', 'lz4', 'none'])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--format', default='auto',
                        choices=['auto', 'lmdb', 'directory'],
                        help='auto falls back to DirectoryDataset when the '
                             'lmdb package is unavailable')
    args = parser.parse_args(argv)

    from ..data import lmdb_reader

    if args.raw_dir:
        samples = directory_samples(args.raw_dir)
    else:
        samples = synthetic_samples(args.num_instances, args.num_views,
                                    args.resolution, args.seed)

    use_lmdb = args.format == 'lmdb' or (
        args.format == 'auto' and lmdb_reader._lmdb is not None)
    if use_lmdb:
        writer = lmdb_reader.LMDBWriter(args.out, compress=args.compress)
        n = 0
        for sample in samples:
            writer.write(sample)
            n += 1
        writer.close()
    else:
        samples = list(samples)
        n = len(samples)
        lmdb_reader.DirectoryDataset.write(args.out, iter(samples))
    kind = 'lmdb' if use_lmdb else 'directory'
    print(f'wrote {n} instances to {args.out} ({kind})')
    return n, kind


if __name__ == '__main__':
    main()
