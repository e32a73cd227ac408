"""Interactive image→3D demo (reference ``scripts/gradio_app.py:90-365``).

Port of ``scripts/gradio_app.py``.  With gradio installed: a web UI
around the image→3D model (orbit frames and the mesh to download).
Without it: a command-line loop over the same ``run_i23d`` — ``--image``,
``--image_dir`` (a folder of real images, reference ``RealDataset``) or a
synthetic render — so the demo path stays exercised:

    python -m ln3diff_tpu_torch.scripts.gradio_app --image_dir imgs/

The runner holds the ``i23d-pixart-l2`` DiT with bf16 weight storage
(``--int8_dit``: the W8A8 twin), the ``objaverse-s`` VAE and the CLIP
vision tower, all random (no released weights are loaded); it samples the
flow-matching ODE for ``--num_steps`` steps at CFG 4.0 and renders the
orbit and the σ grid through the fused point kernel.  ``--device``
(default ``cuda``) picks the device.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--outdir', default=os.path.join(
        tempfile.gettempdir(), 'ln3diff-demo'))
    parser.add_argument('--num_steps', type=int, default=75)
    parser.add_argument('--num_frames', type=int, default=12)
    parser.add_argument('--render_resolution', type=int, default=128)
    parser.add_argument('--mesh_grid', type=int, default=128)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--int8_dit', action='store_true',
                        help='W8A8 int8 quantized DiT serving')
    parser.add_argument('--image', default='',
                        help='CLI mode: input image path')
    parser.add_argument('--image_dir', default='',
                        help='CLI mode: directory of real eval images '
                             '(reference RealDataset, '
                             'g_buffer_objaverse.py:2531) — runs i23d on '
                             'each')
    parser.add_argument('--device', default='cuda')
    return parser


def image_condition(image_np: np.ndarray, vision, device):
    """(H, W, 3) uint8 → the (cond, uncond) pair: the image in [-1, 1],
    bilinear-resized (antialiased when it shrinks) to the tower's
    resolution, through the CLIP vision tower; its tokens' first 1024
    channels as 'crossattn', the pooled feature's first 768 as 'vector',
    zeros for uncond (JAX :81-89)."""
    import torch.nn.functional as F
    img = torch.as_tensor(image_np.astype(np.float32) / 127.5 - 1.0,
                          device=device)
    hw = vision.cfg.image_size
    img = F.interpolate(img[None].permute(0, 3, 1, 2), size=(hw, hw),
                        mode='bilinear', align_corners=False,
                        antialias=True).permute(0, 2, 3, 1)
    with torch.no_grad():
        enc = vision(img)
    cond = {'crossattn': enc['tokens'][:, :, :1024],
            'vector': enc['pooler_output'][:, :768]}
    return cond, {k: torch.zeros_like(v) for k, v in cond.items()}


def build_runner(args, den_cfg=None, vae_cfg=None, vision_cfg=None,
                 render_opts=None):
    """The image→3D runner → ``run_i23d(image_np, outdir, tag='out')``,
    which writes the orbit frames (PNGs), ``{tag}.avi`` and ``{tag}.obj``
    and returns (frame paths, mesh path).  The configs default to the
    release's; the weights are drawn from seeded generators."""
    from ..conditioning.clip import CLIPVisionConfig, CLIPVisionModel
    from ..config import RENDER_PRESETS, denoiser_preset, vae_preset
    from ..models.dit import DiT_TriLatent
    from ..models.layers import random_init_
    from ..models.vae import TriplaneVAE
    from ..pipeline import (SamplerSpec, TextTo3DPipeline, resolve_device,
                            save_video_frames)
    from ..utils.misc import cast_floating
    from ..utils.video import save_video_avi

    device = resolve_device(args.device)
    den_cfg = den_cfg or denoiser_preset('i23d-pixart-l2')
    vae_cfg = vae_cfg or vae_preset('objaverse-s')
    opts = render_opts or RENDER_PRESETS[
        'objverse_tuneray_aug_resolution_64_64_auto']

    def make(ctor, seed):
        with torch.device(device):
            m = ctor().to(device)   # buffers made from numpy too
        return random_init_(m, torch.Generator(device=device).manual_seed(
            seed)).eval()

    # bf16 weight storage (a bf16-compute DiT: half the weight bytes)
    denoiser = cast_floating(make(lambda: DiT_TriLatent(den_cfg), 1),
                             torch.bfloat16)
    if args.int8_dit:
        from ..ops.int8 import quantize_dit
        denoiser = quantize_dit(denoiser)
    vae = make(lambda: TriplaneVAE(vae_cfg), 2).cast_decoder()
    vision = make(lambda: CLIPVisionModel(vision_cfg or CLIPVisionConfig()),
                  3)

    hw = den_cfg.input_size
    pipeline = TextTo3DPipeline(
        denoiser, vae.decode_latent,
        lambda planes, cam: vae.render(planes, cam, opts,
                                       args.render_resolution,
                                       use_fused_osg=True)['image_raw'],
        lambda planes, coords: vae.query_points(
            planes, coords, opts.box_warp, use_fused_osg=True),
        sampler=SamplerSpec(kind='flow_matching', num_steps=args.num_steps,
                            cfg_scale=4.0,
                            latent_shape=(hw, hw, 3 * den_cfg.in_channels)),
        device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def run_i23d(image_np: np.ndarray, outdir: str, tag: str = 'out'):
        """image_np: (H, W, 3) uint8 → orbit frames + mesh paths."""
        os.makedirs(outdir, exist_ok=True)
        cond, uncond = image_condition(image_np, vision, device)
        mesh_path = os.path.join(outdir, f'{tag}.obj')
        out = pipeline(cond, uncond, batch=1, num_frames=args.num_frames,
                       mesh_path=mesh_path, mesh_grid=args.mesh_grid,
                       render_resolution=args.render_resolution,
                       generator=generator)
        video = out['video'][0].float().cpu().numpy()
        frames = save_video_frames(video, os.path.join(outdir, tag))
        save_video_avi(video, os.path.join(outdir, f'{tag}.avi'))
        return frames, mesh_path

    run_i23d.modules = dict(denoiser=denoiser, vae=vae, vision=vision)
    run_i23d.pipeline = pipeline
    return run_i23d


def main(argv=None, **runner_kw):
    """The UI with gradio, else the command-line fallback → the list of
    (tag, frame paths, mesh path) the fallback wrote (empty after the
    UI).  ``runner_kw`` goes to :func:`build_runner` (a test passes toy
    configs)."""
    from ..utils.misc import optional_import

    args = build_parser().parse_args(argv)
    run_i23d = build_runner(args, **runner_kw)
    gr = optional_import('gradio')

    if gr is not None and not args.image:
        def infer(image):
            return run_i23d(np.asarray(image), args.outdir)

        demo = gr.Interface(
            fn=infer,
            inputs=gr.Image(type='numpy', label='input view'),
            outputs=[gr.Gallery(label='orbit views'),
                     gr.File(label='mesh (.obj)')],
            title='ln3diff image→3D')
        demo.launch()
        return []

    # the command-line fallback
    from PIL import Image

    if args.image_dir:
        # i23d eval over a real-image folder (reference RealDataset)
        from ..data.objaverse_raw import RealDataset
        ds = RealDataset(args.image_dir, reso=224, reso_encoder=224,
                         imgnet_normalize=False)
        written = []
        for i in range(len(ds)):
            sample = ds[i]
            img = ((sample['img'] + 1) * 127.5).astype(np.uint8)
            tag = os.path.splitext(os.path.basename(sample['fname']))[0]
            frames, mesh = run_i23d(img, args.outdir, tag=tag)
            print(f'[{i + 1}/{len(ds)}] {tag}: {len(frames)} frames, '
                  f'{mesh}')
            written.append((tag, frames, mesh))
        return written

    if args.image:
        img = np.asarray(Image.open(args.image).convert('RGB'))
    else:
        print('no gradio and no --image given; using a synthetic render')
        from ..data.synthetic import make_multiview_batch
        batch = make_multiview_batch(num_views=1, resolution=224,
                                     render_resolution=224)
        img = ((batch['img_hr'][0] + 1) * 127.5).astype(np.uint8)

    frames, mesh = run_i23d(img, args.outdir)
    print(f'wrote {len(frames)} frames and {mesh}')
    return [('out', frames, mesh)]


if __name__ == '__main__':
    main()
