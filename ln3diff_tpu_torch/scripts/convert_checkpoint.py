"""Convert released LN3Diff torch checkpoints to the ``.npz`` trees that
both packages' sample entries load.

Port of ``scripts/convert_checkpoint.py``.  The reference releases joint
``model_joint_denoise_rec_model*.pt`` / ``.safetensors`` files holding the
denoiser (``ddpm_model.``) and the VAE (``rec_model.``) under name
prefixes (reference ``guided_diffusion/fp16_util.py:299-303``).  This CLI
maps them onto the JAX package's param trees
(``conditioning/convert_ln3diff.py``) and writes ``denoiser.npz``,
``vae.npz`` and ``mixing_logit.npy`` with the same arrays, under the same
names and in the same order as the JAX package's CLI, so that one
converted directory serves both packages:

    python -m ln3diff_tpu_torch.scripts.convert_checkpoint \\
        --src model_joint_denoise_rec_model3910000.safetensors \\
        --kind joint-objaverse --outdir ckpt --verify

``--verify`` builds the port's target modules on the ``meta`` device and
checks the bridged names and shapes against their state dicts: every
EXTRA, MISSING or SHAPE mismatch is printed and the run exits non-zero.
The conversion itself runs on the host (numpy); no card is needed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..bridge import KINDS, reference_trees, trees_state_dicts

_FLAGS = ('dit_depth', 'dit2_depth', 'denoiser_variant', 'fusion_depth',
          'encoder_depth')


def convert(kind: str, sd, args) -> dict:
    """state dict → {'denoiser': tree, 'vae': tree, ...} per kind."""
    if kind not in KINDS:
        raise SystemExit(f'unknown --kind {kind!r} (choices: {KINDS})')
    return reference_trees(kind, sd, **{f: getattr(args, f) for f in _FLAGS})


def target_module(kind: str, which: str, args) -> torch.nn.Module:
    """The port's module that ``which`` (``'denoiser'`` or ``'vae'``) of
    ``kind`` loads into, at the release presets' size, on the ``meta``
    device (names and shapes only)."""
    from ..config import build_vae, denoiser_preset, vae_preset
    with torch.device('meta'):
        if which == 'denoiser':
            if kind == 'joint-objaverse':
                from ..models.dit import DiT_TriLatent
                return DiT_TriLatent(denoiser_preset('t23d-dit-l2'))
            from ..models.unet import UNetModel
            return UNetModel(denoiser_preset('shapenet-unet'))
        dataset = kind.rsplit('-', 1)[-1]
        return build_vae(vae_preset(dataset), encoder=True)


def verify_tree(converted: dict, module: torch.nn.Module, to_state_dict,
                label: str) -> int:
    """The bridged ``converted`` tree against ``module``'s state dict,
    name for name and shape for shape; prints each mismatch and returns
    their count."""
    got = {k: tuple(v.shape) for k, v in to_state_dict(converted).items()}
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    errors = 0
    for name in sorted(set(got) | set(want)):
        if name not in want:
            print(f'  [{label}] EXTRA     {name} {got[name]}')
            errors += 1
        elif name not in got:
            print(f'  [{label}] MISSING   {name} {want[name]}')
            errors += 1
        elif got[name] != want[name]:
            print(f'  [{label}] SHAPE     {name} converted {got[name]} != '
                  f'model {want[name]}')
            errors += 1
    print(f'  [{label}] {len(want)} leaves, {errors} mismatches')
    return errors


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--src', required=True,
                        help='.pt or .safetensors reference checkpoint')
    parser.add_argument('--kind', required=True, choices=KINDS)
    parser.add_argument('--outdir', required=True)
    parser.add_argument('--verify', action='store_true',
                        help='check the converted trees against the '
                             "port's modules (names + shapes)")
    parser.add_argument('--dit_depth', type=int, default=24)
    parser.add_argument('--dit2_depth', type=int, default=24)
    parser.add_argument('--denoiser_variant', default='text')
    parser.add_argument('--fusion_depth', type=int, default=6)
    parser.add_argument('--encoder_depth', type=int, default=12)
    return parser


def main(argv=None) -> dict:
    """Convert ``--src`` into ``--outdir``; returns ``{name: path}`` of the
    files written."""
    from ..conditioning.convert import load_torch_checkpoint
    from ..training.checkpoint import flatten_jax_tree, save_jax_tree_npz
    args = build_parser().parse_args(argv)

    sd = load_torch_checkpoint(args.src)
    print(f'{args.src}: {len(sd)} tensors')
    out = convert(args.kind, sd, args)
    del sd

    os.makedirs(args.outdir, exist_ok=True)
    written = {}
    total_errors = 0
    for name, tree in out.items():
        if name == 'mixing_logit':
            path = os.path.join(args.outdir, 'mixing_logit.npy')
            np.save(path, np.asarray(tree))
            print(f'wrote {path}')
            written[name] = path
            continue
        if args.verify:
            total_errors += verify_tree(
                tree, target_module(args.kind, name, args),
                lambda t, n=name: trees_state_dicts(args.kind, {n: t})[n],
                name)
        path = os.path.join(args.outdir, f'{name}.npz')
        save_jax_tree_npz(path, tree)
        print(f'wrote {path} ({len(flatten_jax_tree(tree))} arrays)')
        written[name] = path
    if args.verify and total_errors:
        raise SystemExit(f'{total_errors} tree mismatches')
    return written


if __name__ == '__main__':
    main()
