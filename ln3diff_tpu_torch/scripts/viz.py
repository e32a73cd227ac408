"""Diffusion diagnostics: noise-schedule render strips.

Port of ``scripts/scripts_lib/viz.py`` (``render_noise_schedule_strip``
:17, ``save_image_strip`` :43), after the reference's
``render_video_noise_schedule`` (``nsr/train_util_diffusion.py``): the
q-noised latents at several diffusion times, decoded and rendered side by
side with the clean render, so that a latent-scale mismatch or a schedule
fault shows at a glance.  Torch cannot replay ``jax.random``, so
``noise=`` takes a given draw (the tests feed JAX's), as ``x_init`` does
for the samplers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


@torch.no_grad()
def render_noise_schedule_strip(latent, camera25, diffusion, decode_fn,
                                render_fn,
                                generator: Optional[torch.Generator] = None,
                                noise: Optional[torch.Tensor] = None,
                                ts=(0.0, 0.25, 0.5, 0.75, 1.0)):
    """Render decoded q(x_t | x_0) latents at several t.

    ``latent`` (1, h, w, C) is the clean VAE latent; ``diffusion`` a
    ``GaussianDiffusion`` (its ``q_sample`` over its schedule);
    ``decode_fn`` maps a latent to planes and ``render_fn(planes,
    camera25)`` to images (B, H, W, 3).  One noise draw serves every t:
    ``noise``, or a normal draw from ``generator``.  The step of each
    fraction is ``int(frac · (T − 1))``.  Returns a (len(ts), H, W, 3)
    float array in [-1, 1], in the order of ``ts`` (t ascending by
    default)."""
    if noise is None:
        noise = torch.randn(latent.shape, generator=generator,
                            device=latent.device, dtype=latent.dtype)
    frames = []
    for frac in ts:
        t = torch.full((latent.shape[0],),
                       int(frac * (diffusion.num_timesteps - 1)),
                       dtype=torch.long, device=latent.device)
        x_t = diffusion.q_sample(latent, t, noise.to(latent))
        planes = decode_fn(x_t)
        frames.append(np.asarray(render_fn(planes, camera25)[0].float()
                                 .cpu()))
    return np.stack(frames)


def save_image_strip(frames: np.ndarray, path: str) -> str:
    """Concatenate (N, H, W, 3) [-1, 1] frames horizontally into one PNG
    at ``path``; returns the path."""
    from PIL import Image
    strip = np.concatenate(list(np.asarray(frames)), axis=1)
    img = ((np.clip(strip, -1, 1) + 1) * 127.5).astype(np.uint8)
    Image.fromarray(img).save(path)
    return path
