"""End-to-end text→3D sampling pipeline.

Port of ``ln3diff_tpu/pipeline.py`` (``SamplerSpec`` :47,
``TextTo3DPipeline`` :55, ``_sample_impl`` / ``_make_cfg_fn`` /
``sample_latents`` :128-200, ``render_orbit`` :202,
``dispatch_mesh_sigma`` :315, ``__call__`` :363-399 on its
``mesh_path=None`` branch):

  1. (cond, uncond) text context;
  2. DDIM over ``(B, 32, 32, 12)`` latents with doubled-batch
     classifier-free guidance (cfg 1.0 runs the conditional half only);
  3. latent × triplane_scaling_divider → VAE decode → planes;
  4. orbit render, frames folded into the batch in memory-budgeted chunks;
  5. the σ-grid query that feeds mesh extraction.

Marching tetrahedra, vertex colours and OBJ/PLY export are the next
slice: a ``mesh_path`` raises ``NotImplementedError``.

The pipeline takes callables over tensors (the JAX version takes
param-explicit ones); :func:`build_t23d_pipeline` assembles the released
Objaverse text→3D model from the port's modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .render.camera import orbit_cameras


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — there
    is no silent fallback to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass device="cpu" '
                           'to run on the CPU')
    return device


def frames_to_uint8(v: torch.Tensor) -> torch.Tensor:
    """[-1, 1] frames → uint8."""
    return ((torch.clamp(v, -1, 1) + 1) * 127.5).to(torch.uint8)


@dataclasses.dataclass
class SamplerSpec:
    """DDIM sampling (the JAX ``kind='ddim'``; the port has no other
    sampler yet) over ``num_steps`` respaced steps of the 1000-step
    schedule."""
    num_steps: int = 250
    cfg_scale: float = 6.5
    triplane_scaling_divider: float = 0.96806
    latent_shape: tuple = (32, 32, 12)


class TextTo3DPipeline:
    """Composable pipeline over callables:

      denoiser_fn(x, t, context) -> prediction
      decode_fn(latents) -> planes (B, 3, H, W, C)
      render_fn(planes, cam25) -> images (B, H, W, 3)
      point_decoder_fn(planes, coords) -> (rgb, sigma)
    """

    def __init__(self, denoiser_fn, decode_fn, render_fn, point_decoder_fn,
                 sampler: SamplerSpec = SamplerSpec(), diffusion=None,
                 render_dtype: Optional[torch.dtype] = None,
                 device='cuda'):
        self.denoiser_fn = denoiser_fn
        self.decode_fn = decode_fn
        self.render_fn = render_fn
        self.point_decoder_fn = point_decoder_fn
        self.spec = sampler
        self.diffusion = diffusion
        # cast decoded planes to this dtype before render / σ queries
        # (bf16 serving: half the gather table, bf16 lerp in the kernel)
        self.render_dtype = render_dtype
        self.device = resolve_device(device)

    # -- latent sampling ---------------------------------------------------

    def _make_cfg_fn(self, cond, uncond, batch: int):
        """Doubled-batch guidance: one denoiser call over [cond; uncond]."""
        scale = self.spec.cfg_scale

        def cfg_fn(x, t):
            both = {k: torch.cat(
                [cond[k].expand(batch, *cond[k].shape[1:]),
                 uncond[k].expand(batch, *uncond[k].shape[1:])], dim=0)
                for k in cond}
            out = self.denoiser_fn(torch.cat([x, x], dim=0),
                                   torch.cat([t, t], dim=0), both)
            c_out, u_out = out.chunk(2, dim=0)
            return u_out + scale * (c_out - u_out)

        return cfg_fn

    @torch.no_grad()
    def sample_latents(self, batch: int, cond, uncond,
                       generator: Optional[torch.Generator] = None,
                       x_init: Optional[torch.Tensor] = None):
        """DDIM with guidance → decoder-space latents (B, h, w, C), i.e.
        already multiplied by ``triplane_scaling_divider``.  The start noise
        is ``x_init`` or a draw from ``generator``."""
        spec = self.spec
        shape = (batch,) + tuple(spec.latent_shape)
        if spec.cfg_scale == 1.0:
            # u + 1·(c − u) = c: run the conditional half only
            def cfg_fn(x, t):
                ctx = {k: c.expand(batch, *c.shape[1:])
                       for k, c in cond.items()}
                return self.denoiser_fn(x, t, ctx)
        else:
            cfg_fn = self._make_cfg_fn(cond, uncond, batch)
        x = self.diffusion.ddim_sample_loop(cfg_fn, shape, device=self.device,
                                            generator=generator,
                                            x_init=x_init)
        return x * spec.triplane_scaling_divider

    # -- render ------------------------------------------------------------

    @torch.no_grad()
    def render_orbit(self, planes, num_frames: int = 24,
                     radius: float = 1.8, fov: float = 30.0,
                     pitch_deg: float = 20.0,
                     render_resolution: Optional[int] = None,
                     hbm_budget_bytes: float = 4e9):
        """Render the evaluation orbit → (B, F, H, W, 3) in [-1, 1].

        Frames fold into the batch in chunks small enough that the
        gathered-corner tensor (frames·3·rays·128 samples·4C·itemsize)
        stays within ``hbm_budget_bytes``: one 192² frame per call with
        bf16 planes and the 4 GB default."""
        C = planes.shape[-1]
        res = render_resolution or 128
        bytes_per_frame = 3 * res * res * 128 * 4 * C * planes.element_size()
        frames_per_call = min(num_frames,
                              max(1, int(hbm_budget_bytes // bytes_per_frame)))
        while num_frames % frames_per_call:
            frames_per_call -= 1
        cams = torch.as_tensor(orbit_cameras(num_frames, radius, fov,
                                             pitch_deg),
                               device=planes.device)
        B = planes.shape[0]
        chunks = []
        for f0 in range(0, num_frames, frames_per_call):
            cam_chunk = cams[f0:f0 + frames_per_call]
            planes_f = planes.repeat_interleave(frames_per_call, dim=0)
            cams_f = cam_chunk.repeat(B, 1)
            imgs = self.render_fn(planes_f, cams_f)
            chunks.append(imgs.reshape(B, frames_per_call, *imgs.shape[1:]))
        return torch.cat(chunks, dim=1)

    def _mesh_decoder(self, planes):
        def decoder(coords):
            return self.point_decoder_fn(planes[:1], coords)
        return decoder

    @torch.no_grad()
    def dispatch_mesh_sigma(self, planes, grid_size: int = 192,
                            aabb: float = 0.45, smooth: bool = False):
        """σ on the ``grid_size³`` grid (flat f16, on the planes' device),
        in chunks of 2^18 points — 27 chunks for 192³.  ``smooth`` applies
        the 3³ box denoise that the serving path (``mesh_smooth=True``)
        uses; the reference marches the raw field."""
        from .render.mesh import query_grid_sigma
        return query_grid_sigma(self._mesh_decoder(planes), grid_size, aabb,
                                chunk=2**18, smooth=smooth,
                                device=planes.device)

    # -- full run ----------------------------------------------------------

    @torch.no_grad()
    def __call__(self, cond, uncond, batch: int = 1, num_frames: int = 24,
                 mesh_path: Optional[str] = None,
                 render_resolution: Optional[int] = None,
                 video_uint8: bool = False,
                 generator: Optional[torch.Generator] = None,
                 x_init: Optional[torch.Tensor] = None):
        """Full run → {'latents', 'planes', 'video'}.  ``video_uint8``
        returns the orbit as host uint8 frames.  The σ grid for a mesh is
        :meth:`dispatch_mesh_sigma`; a ``mesh_path`` (marching and export)
        is the next slice and raises."""
        if mesh_path:
            raise NotImplementedError('mesh export: next slice')
        latents = self.sample_latents(batch, cond, uncond,
                                      generator=generator, x_init=x_init)
        planes = self.decode_fn(latents)
        out = {'latents': latents, 'planes': planes}
        if self.render_dtype is not None:
            planes = planes.to(self.render_dtype)
        video = self.render_orbit(planes, num_frames,
                                  render_resolution=render_resolution)
        if video_uint8:
            video = frames_to_uint8(video).cpu().numpy()
        out['video'] = video
        return out


def build_t23d_pipeline(device='cuda', seed: int = 0, den_cfg=None,
                        vae_cfg=None, text_cfg=None, render_opts=None,
                        render_resolution: int = 192,
                        sampler: Optional[SamplerSpec] = None,
                        render_dtype: Optional[torch.dtype] = torch.bfloat16,
                        modules: Optional[dict] = None):
    """The released Objaverse text→3D model on ``device``.

    Defaults are the serving configuration: DiT-L/2 with tanh GELU stored
    and run in bf16, the DiT2-L/2 VAE decoder in bf16, the f32 CLIP text
    tower, 250-step DDIM with CFG 6.5, 192² renders with 64+64 samples
    through the fused point kernel, bf16 planes.  Weights are random,
    drawn from a ``torch.Generator`` seeded with ``seed`` — unless
    ``modules`` supplies ``{'denoiser', 'vae', 'text_model'}`` (for
    example loaded through ``bridge.py``).

    Returns ``(pipeline, encode, modules)``; ``encode(prompt)`` gives the
    (cond, uncond) context pair.
    """
    from .conditioning.clip import (CLIPTextConfig, CLIPTextModel,
                                    default_tokenizer)
    from .config import RENDER_PRESETS, denoiser_preset, vae_preset
    from .diffusion.gaussian import make_diffusion
    from .models.dit import DiT_TriLatent
    from .models.layers import random_init_
    from .models.vae import TriplaneVAE

    device = resolve_device(device)
    if den_cfg is None:
        den_cfg = dataclasses.replace(denoiser_preset('t23d-dit-l2'),
                                      exact_gelu=False)
    vae_cfg = vae_cfg or vae_preset('objaverse')
    text_cfg = text_cfg or CLIPTextConfig()
    opts = render_opts or RENDER_PRESETS[
        'objverse_tuneray_aug_resolution_64_64_auto']
    sampler = sampler or SamplerSpec()

    if modules is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        with torch.device(device):
            modules = dict(denoiser=DiT_TriLatent(den_cfg),
                           vae=TriplaneVAE(vae_cfg),
                           text_model=CLIPTextModel(text_cfg))
        for m in modules.values():
            random_init_(m, gen)
    denoiser = modules['denoiser'].to(device).to(den_cfg.dtype).eval()
    vae = modules['vae'].to(device).cast_decoder().eval()
    text_model = modules['text_model'].to(device).eval()
    tokenizer = default_tokenizer(max_length=text_cfg.max_length)

    pipeline = TextTo3DPipeline(
        denoiser,
        vae.decode_latent,
        lambda planes, cam: vae.render(
            planes, cam, opts, render_resolution,
            use_fused_osg=True)['image_raw'],
        lambda planes, coords: vae.query_points(
            planes, coords, opts.box_warp, use_fused_osg=True),
        sampler=sampler,
        diffusion=make_diffusion(
            steps=1000, timestep_respacing=f'ddim{sampler.num_steps}'),
        render_dtype=render_dtype, device=device)

    @torch.no_grad()
    def encode(prompt: str):
        ids = torch.as_tensor(tokenizer([prompt, '']), device=device)
        both = text_model(ids)['last_hidden_state']
        return {'crossattn': both[:1]}, {'crossattn': both[1:]}

    return pipeline, encode, dict(denoiser=denoiser, vae=vae,
                                  text_model=text_model)
