"""Shared helpers of the training entry points.

Port of ``scripts/scripts_lib/__init__.py`` (``train_until``) and
``scripts/scripts_lib/eval_vae.py`` (``eval_novelview_loop``), plus the
set-up every training CLI shares: the process group, the rank-0 logger
and the resume from a checkpoint.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch


def setup(cfg, device):
    """Join ``torchrun``'s process group (a no-op without one), configure
    the logger — the log directory's sinks on rank 0, none elsewhere — and
    write ``args.json`` on rank 0.  Returns ``(device, rank, world)``."""
    from ..parallel.mesh import host_shard, initialize_distributed
    from ..pipeline import resolve_device
    from ..utils import logger
    device = resolve_device(device)
    initialize_distributed(device)
    if device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device())
    rank, world = host_shard()
    logger.configure(cfg.logdir, format_strs=None if rank == 0 else ())
    if rank == 0:
        with open(os.path.join(cfg.logdir, 'args.json'), 'w') as f:
            f.write(cfg.to_json())
    return device, rank, world


def tile_instances(stream, n: int):
    """Each batch of ``stream`` (one instance's views, as the overfitting
    stream gives) repeated ``n`` times along the leading axis: a global
    batch of ``n`` instances, which the (data, fsdp) ranks split whole."""
    for batch in stream:
        yield {k: (np.concatenate([v] * n) if isinstance(v, np.ndarray)
                   and v.ndim else v) for k, v in batch.items()}


def metric_log(metrics: dict, log: Callable) -> Callable:
    """A ``run_loop`` ``log``: a metrics dict replaces ``metrics`` and goes
    to the logger's key-values, a message to ``log``."""
    from ..utils import logger

    def fn(m):
        if isinstance(m, dict):
            metrics.clear()
            metrics.update(m)
            logger.logkvs(m)
            logger.dumpkvs()
        else:
            log(m)
    return fn


def resume(trainer, ckpt, cfg, log: Callable) -> None:
    """Restore the latest checkpoint into ``trainer.state`` when
    ``cfg.resume_checkpoint`` is set."""
    if cfg.resume_checkpoint and ckpt.restore(trainer.state) is not None:
        log(f'resumed from step {trainer.state.step}')


def train_until(trainer, data, total_steps: int, save_interval: int, ckpt,
                log: Callable = print, **run_kwargs) -> int:
    """Chunked train loop with checkpointing and preemption safety.

    Runs ``trainer.run_loop`` in ``save_interval``-step chunks, saving a
    checkpoint after each; a SIGTERM stops every rank at the same step
    boundary (``PreemptionGuard``) and saves before returning.  Returns
    the final step.  Extra kwargs go to ``run_loop``."""
    from ..training.preemption import PreemptionGuard

    step = int(trainer.state.step)
    with PreemptionGuard() as guard:
        while step < total_steps:
            n = min(save_interval, total_steps - step)
            trainer.run_loop(data, num_steps=n, step_offset=step,
                             guard=guard, log=log, **run_kwargs)
            step = int(trainer.state.step)
            ckpt.save(step, trainer.state)
            log(f'saved checkpoint @ {step}')
            if guard.preempted:
                log('preempted: checkpoint saved, exiting cleanly')
                break
    return step


@torch.no_grad()
def eval_novelview_loop(trainer, data, cfg, save_latent: bool = False,
                        num_instances: int = 1, num_views: int = 8,
                        use_ema: bool = False, log: Callable = print
                        ) -> list:
    """The VAE's novel-view evaluation (reference ``eval_novelview_loop``,
    ``nsr/train_nv_util.py:1177``): per instance, encode → the
    posterior's mean → planes → ``num_views`` views of the family's orbit
    written through ``save_video_frames`` (PNGs under ``logdir/eval``);
    with ``save_latent`` the latent ``(B, h, w, 12)`` as f32 ``.npy`` for
    stage 2.  ``use_ema`` evaluates the EMA weights (at rate 0.9999 they
    are about the initial ones for a short run).  Files are written on
    rank 0.  Returns the written frame paths."""
    from ..config import CAMERA_PRESETS
    from ..parallel.mesh import host_shard
    from ..pipeline import save_video_frames
    from ..render.camera import orbit_cameras

    write = host_shard()[0] == 0
    model = trainer.model
    state = trainer.state
    saved = {}
    if use_ema:
        for k, p in state.module_params().items():
            saved[k] = p.detach().clone()
        state.load_module({k: e.full_tensor() if hasattr(e, 'full_tensor')
                           else e for k, e in state.ema_params['ema'].items()})
    outdir = os.path.join(cfg.logdir, 'eval')
    os.makedirs(outdir, exist_ok=True)
    cam_kw = CAMERA_PRESETS.get(cfg.dataset, {})
    cams = torch.as_tensor(orbit_cameras(
        num_views, radius=cam_kw.get('radius', 1.8),
        fov=cam_kw.get('fov', 30.0)), dtype=torch.float32,
        device=trainer.device)
    paths = []
    try:
        for i in range(num_instances):
            batch = next(data)
            imgs = torch.as_tensor(batch['img_to_encoder'],
                                   device=trainer.device)
            with trainer._autocast():
                moments = model.encode(imgs)
                latent, _ = model.reparameterize(moments, False)
                planes = model.decode_latent(latent)
            if save_latent and write:
                np.save(os.path.join(outdir, f'latent_{i:04d}.npy'),
                        latent.float().cpu().numpy())
            frames = [model.render(
                planes, cams[v][None].expand(planes.shape[0], 25),
                trainer.render_opts, trainer.cfg.render_resolution)
                ['image_raw'][0] for v in range(num_views)]
            if write:
                paths += save_video_frames(torch.stack(frames),
                                           os.path.join(outdir, f'nv_{i:04d}'))
            log(f'instance {i}: wrote {num_views} novel views'
                + (' + latent' if save_latent else ''))
    finally:
        for k, p in state.module_params().items():
            if k in saved:
                p.copy_(saved[k])
    return paths
