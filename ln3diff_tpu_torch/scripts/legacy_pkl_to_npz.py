"""Convert a StyleGAN legacy persistence ``.pkl`` to a flat ``.npz``.

Port of ``scripts/legacy_pkl_to_npz.py``.  The reference loads these
pickles by executing the pickled source code
(``utils/torch_utils/legacy.py:368`` + ``persistence.py:37``); this
extractor captures the pickled state without executing anything
(``ln3diff_tpu_torch/utils/legacy_pkl.py``) and writes
``<network>.<dotted_param>`` numpy arrays, the input of
``convert_eg3d_generator`` (the EG3D warm-up's ``--teacher_ckpt``):

    python -m ln3diff_tpu_torch.scripts.legacy_pkl_to_npz ffhq512-128.pkl out.npz
    python -m ln3diff_tpu_torch.scripts.legacy_pkl_to_npz net.pkl out.npz --keys G_ema
    python -m ln3diff_tpu_torch.scripts.legacy_pkl_to_npz net.pkl --describe

The extraction runs on the host; no card is needed.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    """Write the npz (returns its flat dict), or with ``--describe`` print
    the networks' class names and init args (returns them)."""
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('pkl')
    p.add_argument('npz', nargs='?', default='')
    p.add_argument('--keys', nargs='*', default=['G_ema', 'G', 'D'],
                   help='top-level networks to extract')
    p.add_argument('--describe', action='store_true',
                   help='print class names + init args and exit')
    args = p.parse_args(argv)

    from ..utils.legacy_pkl import describe, legacy_pkl_to_npz, load_stubbed

    if args.describe:
        data = load_stubbed(args.pkl)
        if isinstance(data, dict):
            info = {k: describe(v) for k, v in data.items()
                    if v is not None and not isinstance(v, (str, int,
                                                            float, dict))}
        else:
            info = describe(data)
        print(json.dumps(info, indent=2, default=repr))
        return info

    if not args.npz:
        p.error('npz output path required unless --describe')
    flat = legacy_pkl_to_npz(args.pkl, args.npz, keys=tuple(args.keys))
    total = sum(v.size for v in flat.values())
    print(f'wrote {args.npz}: {len(flat)} arrays, {total / 1e6:.2f} M '
          'params')
    for k in sorted(flat)[:8]:
        print(f'  {k} {flat[k].shape}')
    if len(flat) > 8:
        print(f'  ... {len(flat) - 8} more')
    return flat


if __name__ == '__main__':
    main()
