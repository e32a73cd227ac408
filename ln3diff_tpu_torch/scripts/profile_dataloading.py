"""Data-loader throughput.

Port of ``scripts/profile_dataloading.py`` (reference
``scripts/profile_dataloading.py``), the same parser: batches/s and MB/s
through each reader path (the synthetic in-memory batch, wds shards, a
directory or LMDB dataset), so that a slow reader shows before it shows as
an idle card:

    python -m ln3diff_tpu_torch.scripts.profile_dataloading
    python -m ln3diff_tpu_torch.scripts.profile_dataloading --path 'DIR/*.tar'
    python -m ln3diff_tpu_torch.scripts.profile_dataloading --path LMDB_OR_DIR

Runs on the host; no card is needed.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _nbytes(sample) -> int:
    total = 0
    for v in sample.values():
        if isinstance(v, np.ndarray):
            total += v.nbytes
        elif isinstance(v, dict):
            total += _nbytes(v)
    return total


def profile(name: str, iterator, num_batches: int):
    """Time ``num_batches`` batches after a first, untimed one; print the
    rates and return the first batch, the batches/s and the MB/s."""
    # warm one batch (open files, build caches) before timing
    first = next(iterator)
    t0 = time.perf_counter()
    nbytes = 0
    for _ in range(num_batches):
        batch = next(iterator)
        nbytes += _nbytes(batch)
    dt = time.perf_counter() - t0
    print(f'{name:>12}: {num_batches / dt:8.1f} batches/s  '
          f'{nbytes / dt / 2**20:8.1f} MB/s  '
          f'({num_batches} batches in {dt:.3f}s)')
    return first, num_batches / dt, nbytes / dt / 2**20


def main(argv=None) -> dict:
    """Profile each path; returns {path name: (batches/s, MB/s)}."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--path', default='',
                        help='LMDB/directory dataset or wds shard glob; '
                             'empty → synthetic only')
    parser.add_argument('--batch_size', type=int, default=4)
    parser.add_argument('--num_batches', type=int, default=50)
    parser.add_argument('--resolution', type=int, default=128)
    args = parser.parse_args(argv)

    from ..data.synthetic import load_memory_data

    rates = {}
    _, *rates['synthetic'] = profile(
        'synthetic', load_memory_data(args.batch_size, num_views=4,
                                      resolution=args.resolution,
                                      render_resolution=args.resolution),
        args.num_batches)

    if not args.path:
        return rates

    if args.path.endswith('.tar') or '*' in args.path:
        import glob

        from ..data.wds import load_wds_data
        paths = sorted(glob.glob(args.path))
        _, *rates['wds'] = profile('wds', load_wds_data(paths,
                                                        args.batch_size),
                                   args.num_batches)
    else:
        from ..data import lmdb_reader
        if os.path.isdir(args.path) and any(
                f.endswith('.npy') for f in os.listdir(args.path)):
            ds = lmdb_reader.DirectoryDataset(args.path)
        else:
            ds = lmdb_reader.LMDBDataset(args.path)
        _, *rates['dataset'] = profile(
            'dataset', lmdb_reader.load_data(ds, args.batch_size),
            args.num_batches)
    return rates


if __name__ == '__main__':
    main()
