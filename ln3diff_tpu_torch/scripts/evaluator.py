"""Standalone sample-set evaluator CLI.

Port of ``scripts/evaluator.py`` (reference ``evaluations/evaluator.py``:
``python evaluator.py ref.npz sample.npz`` → FID / sFID / IS / Precision /
Recall over the ``arr_0`` uint8 image batches).  The default extractor is
the FID InceptionV3 (pool3, logits and the ``mixed_6/conv`` spatial
features, ``evaluation/inception.py``); ``--inception_weights`` takes the
pytorch-fid ``pt_inception-2015-12-05`` state dict for numbers comparable
with the reference (random weights otherwise).  ``--extractor clip`` runs
the narrow CLIP vision tower instead.

    python -m ln3diff_tpu_torch.scripts.evaluator ref.npz sample.npz \\
        --inception_weights pt_inception-2015-12-05.pth

``--device`` (default ``cuda``) picks the device.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('ref_batch', help='npz with arr_0 (N,H,W,3) uint8')
    parser.add_argument('sample_batch', help='npz with arr_0 (N,H,W,3) uint8')
    parser.add_argument('--batch_size', type=int, default=32)
    parser.add_argument('--extractor', choices=('inception', 'clip'),
                        default='inception')
    parser.add_argument('--inception_weights', default=None,
                        help='torch state dict (pytorch-fid layout)')
    parser.add_argument('--device', default='cuda')
    return parser


def main(argv=None):
    """Evaluate, print the ``EvalResult`` and return it."""
    from ..evaluation.metrics import (evaluate_npz, make_clip_feature_fn,
                                      make_inception_feature_fn)

    args = build_parser().parse_args(argv)
    if args.extractor == 'inception':
        feature_fn = make_inception_feature_fn(
            weights=args.inception_weights, batch_size=args.batch_size,
            device=args.device)
    else:
        feature_fn = make_clip_feature_fn(batch_size=args.batch_size,
                                          device=args.device)
    result = evaluate_npz(args.ref_batch, args.sample_batch,
                          feature_fn=feature_fn)
    print(result)
    return result


if __name__ == '__main__':
    main()
