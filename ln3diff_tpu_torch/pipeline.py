"""End-to-end text→3D sampling pipeline.

Port of ``ln3diff_tpu/pipeline.py`` (``SamplerSpec`` :47,
``TextTo3DPipeline`` :55, ``_sample_impl`` / ``_make_cfg_fn`` /
``sample_latents`` :128-200, ``render_orbit`` :202,
``dispatch_mesh_sigma`` :315, ``export_mesh`` :347, ``__call__`` :363,
``save_video_frames`` :447):

  1. (cond, uncond) text context;
  2. DDIM over ``(B, 32, 32, 12)`` latents with doubled-batch
     classifier-free guidance (cfg 1.0 runs the conditional half only);
  3. latent × triplane_scaling_divider → VAE decode → planes;
  4. orbit render, frames folded into the batch in memory-budgeted chunks;
  5. with a ``mesh_path``: σ-grid query, marching tetrahedra on the host,
     per-vertex colours and the OBJ/PLY export, interleaved with the orbit.

The JAX version's explicit ``cameras`` and its multi-chip sharding are not
ported.

The pipeline takes callables over tensors (the JAX version takes
param-explicit ones); :func:`build_t23d_pipeline` assembles the released
Objaverse text→3D model from the port's modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
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
                     hbm_budget_bytes: float = 4e9,
                     frame_slice: Optional[tuple] = None):
        """Render the evaluation orbit → (B, F, H, W, 3) in [-1, 1].

        Frames fold into the batch in chunks small enough that the
        gathered-corner tensor (frames·3·rays·128 samples·4C·itemsize)
        stays within ``hbm_budget_bytes``: one 192² frame per call with
        bf16 planes and the 4 GB default.  ``frame_slice=(a, b)`` renders
        only frames [a, b) of the same ring of cameras."""
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
        if frame_slice is not None:
            a, b = frame_slice
            cams = cams[a:b]
            num_frames = b - a
            frames_per_call = min(frames_per_call, num_frames)
            while num_frames % frames_per_call:
                frames_per_call -= 1
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

    @torch.no_grad()
    def export_mesh(self, planes, path: str, grid_size: int = 192,
                    aabb: float = 0.45, threshold: float = 10.0,
                    sigma_grid=None, smooth: bool = False):
        """Mesh of the first instance (reference 192³ grid, σ > 10, −90°
        about x) written to ``path`` (``.ply`` or OBJ) → (verts, faces)."""
        from .render.mesh import export_obj, export_ply, extract_mesh, rotate_x
        verts, colors, faces = extract_mesh(
            self._mesh_decoder(planes), grid_size=grid_size, aabb=aabb,
            threshold=threshold, sigma_grid=sigma_grid, smooth=smooth,
            device=planes.device)
        verts = rotate_x(verts, -90.0)
        (export_ply if path.endswith('.ply') else export_obj)(
            path, verts, colors, faces)
        return verts, faces

    # -- full run ----------------------------------------------------------

    @torch.no_grad()
    def __call__(self, cond, uncond, batch: int = 1, num_frames: int = 24,
                 mesh_path: Optional[str] = None, mesh_grid: int = 192,
                 render_resolution: Optional[int] = None,
                 video_uint8: bool = False,
                 generator: Optional[torch.Generator] = None,
                 x_init: Optional[torch.Tensor] = None,
                 mesh_smooth: bool = True):
        """Full run → {'latents', 'planes', 'video'} and, with a
        ``mesh_path``, 'mesh' = (verts, faces) of the file written there.
        ``video_uint8`` returns the orbit as host uint8 frames.
        ``mesh_smooth`` (serving default) runs the 3³ σ denoise before
        marching; False marches the reference's raw field."""
        latents = self.sample_latents(batch, cond, uncond,
                                      generator=generator, x_init=x_init)
        planes = self.decode_fn(latents)
        out = {'latents': latents, 'planes': planes}
        if self.render_dtype is not None:
            planes = planes.to(self.render_dtype)
        if mesh_path:
            video, out['mesh'] = self._orbit_and_mesh(
                planes, num_frames, render_resolution, mesh_path, mesh_grid,
                mesh_smooth)
        else:
            video = self.render_orbit(planes, num_frames,
                                      render_resolution=render_resolution)
        if video_uint8:
            video = frames_to_uint8(video).cpu().numpy()
        out['video'] = video
        return out

    def _orbit_and_mesh(self, planes, num_frames, render_resolution,
                        mesh_path, mesh_grid, mesh_smooth):
        """The orbit and the mesh, interleaved as in the JAX pipeline
        (``pipeline.py:401-444``): σ query, crossing count and the head
        quarter of the orbit are queued; the σ grid comes to the host only
        when the count is non-zero; the rest of the orbit is queued before
        the host march, so the device renders while the host marches (no
        synchronisation sits between them: the stream stays busy); then
        the vertex colours and the export."""
        from .render.mesh import (count_crossing_cells,
                                  dispatch_vertex_colors, export_obj,
                                  export_ply, march_grid, rotate_x)
        sigma_grid = self.dispatch_mesh_sigma(planes, mesh_grid,
                                              smooth=mesh_smooth)
        n_cross = count_crossing_cells(sigma_grid, mesh_grid)
        head = min(max(num_frames // 4, 1), num_frames)
        v1 = self.render_orbit(planes, num_frames,
                               render_resolution=render_resolution,
                               frame_slice=(0, head))
        sigma_np = sigma_grid.cpu().numpy() if int(n_cross) else None
        v2 = None
        if head < num_frames:
            v2 = self.render_orbit(planes, num_frames,
                                   render_resolution=render_resolution,
                                   frame_slice=(head, num_frames))
        if sigma_np is not None:
            verts, faces = march_grid(sigma_np, mesh_grid)
        else:
            verts = np.zeros((0, 3), np.float32)
            faces = np.zeros((0, 3), np.int64)
        verts_w = rotate_x(verts, -90.0)
        rgb = dispatch_vertex_colors(self._mesh_decoder(planes), verts,
                                     as_uint8=True, device=planes.device)
        colors = np.zeros_like(verts) if rgb is None \
            else rgb.cpu().numpy().astype(np.float32) / 255.0
        (export_ply if mesh_path.endswith('.ply') else export_obj)(
            mesh_path, verts_w, colors, faces)
        video = v1 if v2 is None else torch.cat([v1, v2], dim=1)
        return video, (verts_w, faces)


def save_video_frames(frames, path_prefix: str):
    """Write (F, H, W, 3) frames in [-1, 1] as ``<prefix>_000.png``, ...;
    returns the paths.  Needs Pillow."""
    from PIL import Image
    paths = []
    for i, f in enumerate(np.asarray(torch.as_tensor(frames).float().cpu())):
        img = ((np.clip(f, -1, 1) + 1) * 127.5).astype(np.uint8)
        p = f'{path_prefix}_{i:03d}.png'
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


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
