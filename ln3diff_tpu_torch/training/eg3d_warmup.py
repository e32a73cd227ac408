"""EG3D warm-up trainer: distil a frozen EG3D generator into the VAE.

Port of ``ln3diff_tpu/training/eg3d_warmup.py`` (``WarmupConfig`` :52,
``smooth_l1`` :75, ``EG3DWarmupTrainer`` :80 with ``_sample_cameras``
:166, the loss of ``_loss_fn`` :181-241 and ``run_loop`` :256) and of its
entry point ``scripts/vit_triplane_eg3d_warmup.py`` (:main below; reference
``TrainLoop3DRecEG3D``, ``nsr/train_util_with_eg3d.py:33-382``) on one
device.  A frozen ``TriPlaneGenerator`` teacher (no grads, no optimizer
state) renders z ~ N(0, I) at a sampled camera with truncation ψ and a
zeroed pose label; the VAE (the student) encodes that render, resized to
its encoder's input, decodes planes and renders the same camera.  The
terms:

* ``img``: MSE of the renders; ``depth``: SmoothL1 of the depths;
* ``shape``: SmoothL1 of the σ of both models at shared uniform box
  coordinates;
* ``plane``: MSE of the planes (the fg half under ``use_background``);
* ``ws``: MSE of the student's ``sr_ws`` and the teacher's last w, when
  the student has a StyleGAN SR head.

The student computes under autocast to its ``dtype`` over f32 parameters
(the renders and point queries in f32), AdamW (clip 0.5) and the EMA as
the other trainers (``train_state.build_train_step``); the renders take
the plain point pipeline, as JAX's step does, and the SR head's output,
which no term reads, is not computed (JAX's jit drops it).

Randomness: the cameras come from ``parallel.mesh.host_rng(seed)``
(``default_rng([seed, rank])``), the JAX trainer's host RNG, so both
sample the same poses on rank 0; z, the shape coordinates, the posterior's ε and the student
render's uniforms come from a ``torch.Generator`` or are passed in
(:class:`WarmupDraws`).  JAX draws z, the coordinates and the VAE key from
``split(rng, 3)``; the VAE splits its key into ε and the render's key.

The teacher's weights are random (seed + 1) unless loaded: from a
JAX-tree ``.npz`` (``load_teacher_npz``) or from the torch-named state
dict of a reference EG3D pickle (``load_teacher_state_dict``: the
``.npz`` that ``utils/legacy_pkl.legacy_pkl_to_npz`` writes, through
``convert_eg3d_generator``, ``w_avg`` included).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import tempfile
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.eg3d import TriPlaneGenerator, TriPlaneGeneratorConfig
from ..models.layers import random_init_, zero_init_like_jax
from ..models.vae import TriplaneVAE
from ..parallel.mesh import host_rng
from ..pipeline import resolve_device
from ..render.camera import fov_to_intrinsics, gaussian_pose
from ..render.renderer import RenderDraws, RenderOptions
from .train_state import TrainState, build_train_step, make_optimizer
from .vae_trainer import train_loop


@dataclasses.dataclass(frozen=True)
class WarmupConfig:
    lr: float = 2e-4
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 0.5
    ema_rate: float = 0.9999
    batch_size: int = 4
    render_resolution: int = 64
    truncation_psi: float = 0.7          # run_G, train_util_with_eg3d.py:117
    num_shape_points: int = 4096         # σ-supervision coords per item
    lambda_img: float = 1.0
    lambda_depth: float = 0.5
    lambda_shape: float = 0.005          # shape_uniform_lambda
    lambda_plane: float = 0.1            # loss_feature_volume weight
    lambda_ws: float = 0.1               # loss_ws weight
    # FFHQ-style pose distribution (reference eval/pose sampling)
    cam_radius: float = 2.7
    cam_fov: float = 18.837
    cam_h_stddev: float = 0.3
    cam_v_stddev: float = 0.155
    log_interval: int = 10
    total_steps: int = 10001


class WarmupDraws(NamedTuple):
    """The random draws of one step: the teacher's ``z`` ``(B, z_dim)``,
    the shape term's ``coords`` ``(B, num_shape_points, 3)`` in the box,
    the student posterior's ``eps`` ``(B, h, w, z, 3)`` and the student
    render's uniforms."""
    z: torch.Tensor
    coords: torch.Tensor
    eps: torch.Tensor
    render: RenderDraws


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """``torch.nn.SmoothL1Loss`` (the reference ``criterion3d_rec``),
    written out as the JAX function is."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


class EG3DWarmupTrainer:
    """The frozen-teacher distillation loop.  ``model``: any module with
    ``TriplaneVAE``'s API built with its encoder (``TriplaneVAE``,
    ``ShapeNetVAE``, ``FFHQVAE``; default ``TriplaneVAE(model_cfg,
    encoder=True)``).  The student's weights are drawn from ``seed``
    (``random_init_``, zero where JAX's init is), the teacher's from
    ``seed + 1``; load others into ``trainer.model`` or
    ``trainer.teacher`` before the first step."""

    def __init__(self, model_cfg,
                 gen_cfg: TriPlaneGeneratorConfig = TriPlaneGeneratorConfig(),
                 warm_cfg: WarmupConfig = WarmupConfig(),
                 render_opts: Optional[RenderOptions] = None,
                 seed: int = 0, model=None, device='cuda'):
        self.device = resolve_device(device)
        self.model_cfg, self.gen_cfg, self.cfg = model_cfg, gen_cfg, warm_cfg
        with torch.device(self.device):
            self.model = (TriplaneVAE(model_cfg, encoder=True)
                          if model is None else model.to(self.device))
            self.teacher = TriPlaneGenerator(gen_cfg)
        for i, mod in enumerate((self.model, self.teacher)):
            random_init_(mod, torch.Generator(
                device=self.device).manual_seed(seed + i))
        zero_init_like_jax(self.model)
        self.teacher.requires_grad_(False)
        # the encoder's input size: the SD encoders' img_resolution or
        # the ViT's image size
        self.enc_res = getattr(model_cfg, 'img_resolution', 0) \
            or model_cfg.encoder_vit.img_size
        self.opts = render_opts or RenderOptions(
            depth_resolution=48, depth_resolution_importance=48,
            ray_start=2.25, ray_end=3.3, box_warp=1.0, white_back=False)
        self.rng = host_rng(seed)
        # JAX's init draws one batch of cameras to trace the models: the
        # draw is repeated so that the loop samples JAX's later cameras
        self._sample_cameras(warm_cfg.batch_size)
        self.seed = seed
        tx = make_optimizer(warm_cfg.lr, warm_cfg.weight_decay,
                            grad_clip=warm_cfg.grad_clip)
        self.state = TrainState.create(
            self.model, tx, ema_rates=(('ema', warm_cfg.ema_rate),))
        self._step_fn = build_train_step(self.loss_fn)
        self.generator: Optional[torch.Generator] = None

    # -- the teacher --------------------------------------------------------

    def load_teacher_npz(self, path: str):
        """The teacher's params from a JAX-tree ``.npz`` (slash-joined
        names, as the JAX package's ``save_numpy_checkpoint`` writes a
        teacher's params), through the bridge and
        ``checkpoint.load_jax_tree_npz``; ``w_avg`` (not in the params)
        keeps its value."""
        from ..bridge import eg3d_generator_state_dict
        from .checkpoint import load_jax_tree_npz
        load_jax_tree_npz(path, self.teacher,
                          lambda tree: eg3d_generator_state_dict(
                              {'params': tree}),
                          keep=('mapping.w_avg',))

    def load_teacher_state_dict(self, flat_sd, prefix: str = 'G_ema.'):
        """A reference teacher from a torch-named flat state dict — a
        legacy EG3D ``.pkl`` through ``utils/legacy_pkl.legacy_pkl_to_npz``
        — through ``convert_eg3d_generator`` and the bridge: the params
        and the tracked ``w_avg`` (without it, ψ < 1 would truncate
        towards the zero vector instead of the teacher's mean w)."""
        from ..bridge import eg3d_generator_state_dict
        from ..conditioning.convert_ln3diff import convert_eg3d_generator
        from .checkpoint import load_state_dict_strict
        params, stats = convert_eg3d_generator(flat_sd, prefix)
        sd = eg3d_generator_state_dict({'params': params, 'stats': stats})
        load_state_dict_strict(self.teacher, sd, what=f'{prefix}*',
                               keep=() if stats else ('mapping.w_avg',))

    # -- host-side camera sampling ------------------------------------------

    def _sample_cameras(self, batch_size: int) -> np.ndarray:
        """``(B, 25)`` f32 labels: FFHQ-style Gaussian poses around the
        front and the warm-up's FOV intrinsics."""
        cfg = self.cfg
        cam2world = gaussian_pose(
            self.rng, np.pi / 2, np.pi / 2,
            horizontal_stddev=cfg.cam_h_stddev,
            vertical_stddev=cfg.cam_v_stddev,
            radius=cfg.cam_radius, batch_size=batch_size)
        intr = fov_to_intrinsics(cfg.cam_fov)
        c25 = np.concatenate(
            [cam2world.reshape(batch_size, 16),
             np.tile(intr.reshape(1, 9), (batch_size, 1))], axis=1)
        return c25.astype(np.float32)

    # -- the loss -------------------------------------------------------------

    def _autocast(self):
        dt = self.model_cfg.dtype
        return torch.autocast(self.device.type, dtype=dt,
                              enabled=dt != torch.float32)

    def loss_fn(self, params, constants, batch: dict,
                draws: Optional[WarmupDraws] = None):
        """(total loss, the unweighted terms) for the cameras
        ``batch['c']`` ``(B, 25)``; every draw from ``draws`` or from
        ``self.generator`` (the train step's signature: the modules hold
        the parameters)."""
        cfg, gen_cfg = self.cfg, self.gen_cfg
        cam = batch['c']
        B, res, dev = cam.shape[0], cfg.render_resolution, cam.device
        gen = self.generator
        half = self.opts.box_warp / 2.0
        if draws is None:
            z = torch.randn((B, gen_cfg.z_dim), generator=gen, device=dev)
            coords = (torch.rand((B, cfg.num_shape_points, 3), generator=gen,
                                 device=dev) * 2 - 1) * half
            eps = render_draws = None
        else:
            z, coords, eps, render_draws = draws

        # the teacher: zeroed pose label, truncation ψ (run_G)
        with torch.no_grad():
            t_out = self.teacher(z, cam, self.opts, res,
                                 torch.zeros((B, gen_cfg.c_dim), device=dev),
                                 truncation_psi=cfg.truncation_psi,
                                 return_ws=True)
            _, sigma_t = self.teacher.query_points(
                t_out['planes'], coords, self.opts.box_warp)

        # the student encodes the teacher's render and re-renders the
        # same camera
        model = self.model
        enc_in = t_out['image_raw']
        if self.enc_res != res:
            enc_in = F.interpolate(
                enc_in.permute(0, 3, 1, 2), size=(self.enc_res,) * 2,
                mode='bilinear', align_corners=False,
                antialias=True).permute(0, 2, 3, 1)
        with self._autocast():
            moments = model.encode(enc_in)
            latent, _ = model.reparameterize(moments, True, eps=eps,
                                             generator=gen)
            s_planes = model.decode_latent(latent)
        s_out = model.render(s_planes, cam, self.opts, res, generator=gen,
                             draws=render_draws, apply_sr=False)
        _, sigma_s = model.query_points(s_planes, coords,
                                        self.opts.box_warp)

        terms = {
            'img': torch.mean((s_out['image_raw'] - t_out['image_raw'])**2),
            'depth': smooth_l1(s_out['image_depth'], t_out['image_depth']),
            'shape': smooth_l1(sigma_s, sigma_t),
        }
        if cfg.lambda_plane > 0:
            if self.model_cfg.use_background:
                s_planes = s_planes[..., :s_planes.shape[-1] // 2]
            terms['plane'] = torch.mean((s_planes - t_out['planes'])**2)
        sr_ws = getattr(model, 'sr_ws', None)
        if cfg.lambda_ws > 0 and sr_ws is not None:
            terms['ws'] = torch.mean((sr_ws[None] - t_out['ws'][:, -1])**2)
        weights = {'img': cfg.lambda_img, 'depth': cfg.lambda_depth,
                   'shape': cfg.lambda_shape, 'plane': cfg.lambda_plane,
                   'ws': cfg.lambda_ws}
        total = sum(weights[k] * v for k, v in terms.items())
        return total, {k: v.detach() for k, v in terms.items()}

    # -- the step and the loop ---------------------------------------------

    def train_step(self, camera25: torch.Tensor,
                   draws: Optional[WarmupDraws] = None) -> dict:
        """One optimizer step at the cameras ``(B, 25)``: the terms,
        ``loss`` and ``grad_norm`` (of the unclipped grads).  The draws
        come from ``draws`` or ``self.generator`` (default: seeded with
        ``seed`` on the device)."""
        if self.generator is None:
            self.generator = torch.Generator(
                device=self.device).manual_seed(self.seed)
        return self._step_fn(self.state, {'c': camera25}, draws)

    def run_loop(self, num_steps: Optional[int] = None, ckpt=None,
                 save_interval: int = 0, guard=None,
                 log: Callable = print) -> TrainState:
        """``num_steps`` (default ``total_steps``) steps at freshly sampled
        cameras (``vae_trainer.train_loop``: the metrics to ``log`` every
        ``log_interval`` steps); every ``save_interval`` steps the state
        goes to ``ckpt`` (a ``CheckpointManager``); a ``guard`` stops the
        loop at the next step boundary."""
        cfg = self.cfg

        def step_fn(_, i):
            cam = torch.as_tensor(self._sample_cameras(cfg.batch_size),
                                  device=self.device)
            return self.train_step(cam)

        train_loop(step_fn, itertools.repeat(None),
                   num_steps or cfg.total_steps, cfg.log_interval, 0, log,
                   guard,
                   eval_fn=ckpt and (lambda step: ckpt.save(step,
                                                            self.state)),
                   eval_interval=save_interval)
        return self.state


# -- the entry point ---------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description='EG3D warm-up: distil a frozen EG3D teacher into the '
                    'VAE before reconstruction training.')
    p.add_argument('--outdir', default=os.path.join(tempfile.gettempdir(),
                                                    'ln3diff-eg3d-warmup'))
    p.add_argument('--vae', default='ffhq',
                   help='VAE preset name (ln3diff_tpu_torch.config.'
                        'vae_preset)')
    p.add_argument('--teacher_ckpt', default='',
                   help='npz teacher params: the torch-named npz of '
                        'legacy_pkl_to_npz (G_ema. or G. keys) or a '
                        'JAX-tree npz (a random teacher when empty)')
    p.add_argument('--lr', type=float, default=2e-4)
    p.add_argument('--batch_size', type=int, default=4)
    p.add_argument('--render_resolution', type=int, default=64)
    p.add_argument('--total_steps', type=int, default=10001)
    p.add_argument('--save_interval', type=int, default=2500)
    p.add_argument('--log_interval', type=int, default=10)
    p.add_argument('--truncation_psi', type=float, default=0.7)
    p.add_argument('--lambda_shape', type=float, default=0.005)
    p.add_argument('--lambda_plane', type=float, default=0.1)
    p.add_argument('--lambda_ws', type=float, default=0.1)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    return p


def main(argv=None) -> EG3DWarmupTrainer:
    """Train the ``--vae`` student against the default teacher under
    ``RENDER_PRESETS['ffhq']``, saving ``{outdir}/ckpt/{step}`` every
    ``save_interval`` steps and at the end; returns the trainer."""
    from ..config import RENDER_PRESETS, build_vae, vae_preset
    from .checkpoint import CheckpointManager
    args = build_parser().parse_args(argv)
    os.makedirs(args.outdir, exist_ok=True)
    vae_cfg = vae_preset(args.vae)
    with torch.device(resolve_device(args.device)):
        model = build_vae(vae_cfg, encoder=True)
    warm = WarmupConfig(
        lr=args.lr, batch_size=args.batch_size,
        render_resolution=args.render_resolution,
        truncation_psi=args.truncation_psi,
        lambda_shape=args.lambda_shape, lambda_plane=args.lambda_plane,
        lambda_ws=args.lambda_ws, log_interval=args.log_interval,
        total_steps=args.total_steps)
    trainer = EG3DWarmupTrainer(vae_cfg, warm_cfg=warm,
                                render_opts=RENDER_PRESETS['ffhq'],
                                seed=args.seed, model=model,
                                device=args.device)
    if args.teacher_ckpt:
        with np.load(args.teacher_ckpt) as data:
            flat = {k: data[k] for k in data.files}
        if any(k.startswith(('G_ema.', 'G.')) for k in flat):
            # torch-named flat dict from legacy_pkl_to_npz: convert it
            prefix = 'G_ema.' if any(k.startswith('G_ema.')
                                     for k in flat) else 'G.'
            trainer.load_teacher_state_dict(flat, prefix=prefix)
        else:
            trainer.load_teacher_npz(args.teacher_ckpt)
        print(f'loaded teacher params from {args.teacher_ckpt}')
    ckpt = CheckpointManager(os.path.join(args.outdir, 'ckpt'))
    state = trainer.run_loop(num_steps=args.total_steps, ckpt=ckpt,
                             save_interval=args.save_interval)
    ckpt.save(int(state.step), state)
    print(f'warm-up done at step {int(state.step)}')
    return trainer


if __name__ == '__main__':
    main()
