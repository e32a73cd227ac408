"""Pack multi-view instances into webdataset tar shards.

Port of ``scripts/wds_create.py`` (reference ``scripts/wds_create.py``),
the same parser: ``--source synthetic`` writes ray-traced spheres
(``data.synthetic.make_multiview_batch``, seed = instance index);
``--source gbuffer`` reads a raw G-Objaverse render tree
(``data.objaverse_raw.MultiViewObjaverseRaw``).  Each instance is one
sample ``{key:06d}.{rgb,depth,alpha,c}.npy`` (f32; rgb in [0, 1]) plus
``caption.txt``, the fields ``data.objaverse.PostProcess`` reads:

    python -m ln3diff_tpu_torch.scripts.wds_create --out DIR/objv-%06d.tar
    python -m ln3diff_tpu_torch.scripts.wds_create --out DIR/objv \\
        --source gbuffer --source_dir RAW --captions caps.json --view_ids 25,0,9,18

Runs on the host; no card is needed.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> list:
    """Write the shards; returns their paths."""
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--out', required=True,
                        help='shard pattern, e.g. /data/objv-%%06d.tar')
    parser.add_argument('--num_instances', type=int, default=8)
    parser.add_argument('--num_views', type=int, default=8)
    parser.add_argument('--resolution', type=int, default=256)
    parser.add_argument('--maxcount', type=int, default=64)
    parser.add_argument('--source', default='synthetic',
                        choices=['synthetic', 'gbuffer'])
    parser.add_argument('--source_dir', default='',
                        help='gbuffer: root of raw G-Objaverse instance '
                             'dirs ({ins}/{idx:05d}/{idx:05d}.png/.json/'
                             '_nd.exr)')
    parser.add_argument('--captions', default='',
                        help='gbuffer: text_captions_cap3d.json path')
    parser.add_argument('--view_ids', default='',
                        help="gbuffer: comma list, e.g. '25,0,9,18'")
    args = parser.parse_args(argv)

    from ..data.synthetic import make_multiview_batch
    from ..data.wds import ShardWriter

    writer = ShardWriter(args.out, maxcount=args.maxcount)
    if args.source == 'gbuffer':
        from ..data.objaverse_raw import Cap3DCaptions, MultiViewObjaverseRaw
        ds = MultiViewObjaverseRaw(
            args.source_dir, resolution=args.resolution,
            captions=Cap3DCaptions(args.captions) if args.captions
            else None,
            view_ids=[int(v) for v in args.view_ids.split(',')]
            if args.view_ids else None)
        n = 0
        for inst in ds:
            writer.write(f'{n:06d}', {
                'rgb.npy': inst['rgb'].astype(np.float32),
                'depth.npy': inst['depth'].astype(np.float32),
                'alpha.npy': inst['alpha'].astype(np.float32),
                'c.npy': inst['c'].astype(np.float32),
                'caption.txt': inst['caption'],
            })
            n += 1
        args.num_instances = n
    else:
        for i in range(args.num_instances):
            b = make_multiview_batch(args.num_views, args.resolution,
                                     args.resolution, seed=i)
            rgb01 = ((b['img_hr'] + 1) / 2).astype(np.float32)
            writer.write(f'{i:06d}', {
                'rgb.npy': rgb01,
                'depth.npy': b['depth'].astype(np.float32),
                'alpha.npy': b['depth_mask'].astype(np.float32),
                'c.npy': b['c'].astype(np.float32),
                'caption.txt': f'a shaded sphere #{i}',
            })
    writer.close()
    print(f'wrote {args.num_instances} instances into '
          f'{len(writer.paths)} shard(s): {writer.paths}')
    return writer.paths


if __name__ == '__main__':
    main()
