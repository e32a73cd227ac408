"""End-to-end text/image/multi-view→3D sampling pipeline.

Port of ``ln3diff_tpu/pipeline.py`` (``SamplerSpec`` :47,
``TextTo3DPipeline`` :55, ``_sample_impl`` / ``_make_cfg_fn`` /
``sample_latents`` :128-200, ``render_orbit`` :202,
``dispatch_mesh_sigma`` :315, ``export_mesh`` :347, ``__call__`` :363,
``save_video_frames`` :447):

  1. (cond, uncond) context from the family's conditioning towers;
  2. the flow-matching ODE (``diffusion/transport.py``), DDIM, PLMS or
     DPM-Solver++(2M) (``diffusion/gaussian.py``, ``dpm_solver.py``) over
     ``(B, 32, 32, 12)`` latents with doubled-batch classifier-free
     guidance (cfg 1.0 runs the conditional half only) and an optional
     LSGM mixing logit;
  3. latent × triplane_scaling_divider → VAE decode → planes;
  4. the orbit render — the analytic ring or explicit ``(F, 25)``
     ``cameras`` — with frames folded into the batch in memory-budgeted
     chunks, or, with a flat-ray renderer ``render_rays_fn`` and batch 1,
     into the ray axis over one set of planes;
  5. with a ``mesh_path``: σ-grid query, marching tetrahedra on the host,
     per-vertex colours and the OBJ/PLY export, interleaved with the orbit.

The JAX version's multi-chip sharding (``serving_mesh``) is not ported.

The pipeline takes callables over tensors (the JAX version takes
param-explicit ones); :func:`build_t23d_pipeline`,
:func:`build_i23d_pipeline` and :func:`build_mv23d_pipeline` assemble the
released Objaverse text→3D, image→3D and multi-view→3D models, and
:func:`build_shapenet_pipeline` and :func:`build_ffhq_pipeline` the
ShapeNet and FFHQ text→3D models (U-Net-320 LSGM, fusion-decoder VAEs
with render-space SR), from the port's modules, as ``bench.py``'s
families configure them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .diffusion.transport import Transport
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
    """``kind``: ``'flow_matching'`` (the JAX default: ``num_steps`` Euler
    steps of the transport's ODE), ``'ddim'`` or ``'plms'`` (over the
    pipeline's diffusion, which the builders respace to
    ``ddim{num_steps}``), or ``'dpm'`` (``num_steps`` DPM-Solver++(2M)
    steps over the full, unspaced schedule)."""
    kind: str = 'flow_matching'
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
      render_rays_fn(planes, ray_o, ray_d) -> features (B, R, C), optional

    ``render_rays_fn`` (``TriplaneVAE.render_rays_flat``) lets a batch-1
    orbit fold its frames into the ray axis: one set of planes and one
    corner-packed table per chunk, no per-frame copy of the planes.
    ``mixing_logit`` is the LSGM learned logit that ``p_mean_variance``
    blends the prediction with (DDPM-family samplers of a diffusion with
    ``mixed_prediction``).
    """

    def __init__(self, denoiser_fn, decode_fn, render_fn, point_decoder_fn,
                 sampler: SamplerSpec = SamplerSpec(), diffusion=None,
                 transport: Optional[Transport] = None,
                 render_rays_fn=None,
                 mixing_logit: Optional[torch.Tensor] = None,
                 render_dtype: Optional[torch.dtype] = None,
                 device='cuda'):
        self.denoiser_fn = denoiser_fn
        self.decode_fn = decode_fn
        self.render_fn = render_fn
        self.point_decoder_fn = point_decoder_fn
        self.render_rays_fn = render_rays_fn
        self.mixing_logit = mixing_logit
        self.spec = sampler
        self.diffusion = diffusion
        self.transport = transport or Transport()
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
        """The sampler of ``spec.kind`` with guidance → decoder-space
        latents (B, h, w, C), i.e. already multiplied by
        ``triplane_scaling_divider``.  The start noise is ``x_init`` or a
        draw from ``generator``."""
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
        draw = dict(device=self.device, generator=generator, x_init=x_init)
        if spec.kind == 'flow_matching':
            x = self.transport.sample_ode(cfg_fn, shape,
                                          num_steps=spec.num_steps, **draw)
        elif spec.kind not in ('ddim', 'plms', 'dpm'):
            raise NotImplementedError(f'sampler kind {spec.kind!r}')
        elif self.diffusion is None:
            raise ValueError(f'kind={spec.kind!r} needs a diffusion')
        elif spec.kind == 'dpm':
            from .diffusion.dpm_solver import dpm_solver_sample_loop
            x = dpm_solver_sample_loop(self.diffusion, cfg_fn, shape,
                                       num_steps=spec.num_steps,
                                       mixing_logit=self.mixing_logit, **draw)
        else:
            loop = (self.diffusion.ddim_sample_loop if spec.kind == 'ddim'
                    else self.diffusion.plms_sample_loop)
            x = loop(cfg_fn, shape, mixing_logit=self.mixing_logit, **draw)
        return x * spec.triplane_scaling_divider

    # -- render ------------------------------------------------------------

    @torch.no_grad()
    def render_orbit(self, planes, num_frames: int = 24,
                     radius: float = 1.8, fov: float = 30.0,
                     pitch_deg: float = 20.0,
                     frames_per_call: Optional[int] = None,
                     render_resolution: Optional[int] = None,
                     samples_per_ray: int = 128,
                     hbm_budget_bytes: float = 4e9,
                     frame_slice: Optional[tuple] = None,
                     cameras=None):
        """Render the evaluation orbit → (B, F, H, W, 3) in [-1, 1].

        ``cameras``: explicit packed ``(F, 25)`` labels (for example
        ``render.camera.load_pose_asset('assets/objv_eval_pose.pt')``, the
        release's evaluation cameras) in place of the analytic ring and
        ``num_frames``.  Frames fold into the batch in chunks of
        ``frames_per_call``, by default as many as keep the
        gathered-corner tensor (frames·3·rays·``samples_per_ray``·4C·
        itemsize) within ``hbm_budget_bytes``: one 192² frame per call
        with bf16 planes and the 4 GB default.  ``frame_slice=(a, b)``
        renders only frames [a, b) of the same cameras."""
        if cameras is not None:
            num_frames = len(cameras)
        res = render_resolution or 128
        if frames_per_call is None:
            C = planes.shape[-1]
            bytes_per_frame = (3 * res * res * samples_per_ray * 4 * C
                               * planes.element_size())
            frames_per_call = max(1, int(hbm_budget_bytes // bytes_per_frame))
        frames_per_call = min(frames_per_call, num_frames)
        while num_frames % frames_per_call:
            frames_per_call -= 1
        if cameras is None:
            cameras = orbit_cameras(num_frames, radius, fov, pitch_deg)
        cams = torch.as_tensor(cameras, dtype=torch.float32,
                               device=planes.device)
        if frame_slice is not None:
            a, b = frame_slice
            cams = cams[a:b]
            num_frames = b - a
            frames_per_call = min(frames_per_call, num_frames)
            while num_frames % frames_per_call:
                frames_per_call -= 1
        B = planes.shape[0]
        if self.render_rays_fn is not None and B == 1:
            return self._render_frames_flat(planes, cams, frames_per_call,
                                            res)
        chunks = []
        for f0 in range(0, num_frames, frames_per_call):
            cam_chunk = cams[f0:f0 + frames_per_call]
            planes_f = planes.repeat_interleave(frames_per_call, dim=0)
            cams_f = cam_chunk.repeat(B, 1)
            imgs = self.render_fn(planes_f, cams_f)
            chunks.append(imgs.reshape(B, frames_per_call, *imgs.shape[1:]))
        return torch.cat(chunks, dim=1)

    def _render_frames_flat(self, planes, cams, frames_per_call, res):
        """Batch-1 orbit with the frames folded into the ray axis: the rays
        of ``frames_per_call`` frames per ``render_rays_fn`` call, against
        the one set of planes → (1, F, res, res, 3)."""
        from .render.ray_sampler import sample_full_rays, unpack_25d_camera
        c2w, intr = unpack_25d_camera(cams)
        ray_o, ray_d = sample_full_rays(c2w, intr, res)      # (F, R, 3)
        ray_o, ray_d = ray_o.reshape(1, -1, 3), ray_d.reshape(1, -1, 3)
        step = frames_per_call * res * res
        chunks = [self.render_rays_fn(planes, ray_o[:, r0:r0 + step],
                                      ray_d[:, r0:r0 + step])[..., :3]
                  for r0 in range(0, ray_o.shape[1], step)]
        return torch.cat(chunks, dim=1).reshape(1, len(cams), res, res, 3)

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
                 cameras=None, mesh_smooth: bool = True):
        """Full run → {'latents', 'planes', 'video'} and, with a
        ``mesh_path``, 'mesh' = (verts, faces) of the file written there.
        ``cameras`` (F, 25) replace the analytic orbit and ``num_frames``.
        ``video_uint8`` returns the orbit as host uint8 frames.
        ``mesh_smooth`` (serving default) runs the 3³ σ denoise before
        marching; False marches the reference's raw field."""
        latents = self.sample_latents(batch, cond, uncond,
                                      generator=generator, x_init=x_init)
        planes = self.decode_fn(latents)
        out = {'latents': latents, 'planes': planes}
        if self.render_dtype is not None:
            planes = planes.to(self.render_dtype)
        if cameras is not None:
            num_frames = len(cameras)
        if mesh_path:
            video, out['mesh'] = self._orbit_and_mesh(
                planes, num_frames, render_resolution, mesh_path, mesh_grid,
                mesh_smooth, cameras)
        else:
            video = self.render_orbit(planes, num_frames,
                                      render_resolution=render_resolution,
                                      cameras=cameras)
        if video_uint8:
            video = frames_to_uint8(video).cpu().numpy()
        out['video'] = video
        return out

    def _orbit_and_mesh(self, planes, num_frames, render_resolution,
                        mesh_path, mesh_grid, mesh_smooth, cameras):
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
                               frame_slice=(0, head), cameras=cameras)
        sigma_np = sigma_grid.cpu().numpy() if int(n_cross) else None
        v2 = None
        if head < num_frames:
            v2 = self.render_orbit(planes, num_frames,
                                   render_resolution=render_resolution,
                                   frame_slice=(head, num_frames),
                                   cameras=cameras)
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


def _objaverse_pipeline(denoiser, vae, opts, render_resolution, sampler,
                        render_dtype, device, diffusion=None, transport=None):
    """The pipeline over the port's modules: the denoiser, the VAE's
    decode, its render and point queries through the fused point kernel."""
    return TextTo3DPipeline(
        denoiser,
        vae.decode_latent,
        lambda planes, cam: vae.render(
            planes, cam, opts, render_resolution,
            use_fused_osg=True)['image_raw'],
        lambda planes, coords: vae.query_points(
            planes, coords, opts.box_warp, use_fused_osg=True),
        sampler=sampler, diffusion=diffusion, transport=transport,
        render_dtype=render_dtype, device=device)


def _sampler_diffusion(sampler: SamplerSpec, **spec):
    """The 1000-step linear schedule that a DDPM-family ``sampler`` runs
    over: respaced to ``ddim{num_steps}`` for ``'ddim'`` and ``'plms'``,
    unspaced for ``'dpm'`` (its own solver grid, as ``bench.py``'s
    ``dpm25`` builds it); None for flow matching.  ``spec``: further
    ``make_diffusion`` fields (the U-Net families' ``mean_type`` and
    ``mixed_prediction``)."""
    from .diffusion.gaussian import make_diffusion
    if sampler.kind == 'flow_matching':
        return None
    if sampler.kind == 'dpm':
        return make_diffusion(steps=1000, **spec)
    if sampler.kind in ('ddim', 'plms'):
        return make_diffusion(steps=1000,
                              timestep_respacing=f'ddim{sampler.num_steps}',
                              **spec)
    raise ValueError(f'sampler kind {sampler.kind!r}')


def _random_modules(device, seed, constructors):
    """``{name: module}`` built on ``device``, every parameter drawn from
    one ``torch.Generator`` seeded with ``seed``."""
    from .models.layers import random_init_
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        modules = {k: make() for k, make in constructors.items()}
    for m in modules.values():
        random_init_(m, gen)
    return modules


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
    through the fused point kernel, bf16 planes.  The checkpoint is a DDPM
    model: ``sampler.kind`` is ``'ddim'``, ``'plms'`` or ``'dpm'``.
    ``den_cfg.quantized`` gives the W8A8 int8 DiT (``ops/int8.py``).
    Weights are random, drawn from a ``torch.Generator`` seeded with
    ``seed`` — unless ``modules`` supplies ``{'denoiser', 'vae',
    'text_model'}`` (for example loaded through ``bridge.py``, or a
    denoiser through ``ops.int8.quantize_dit``).

    Returns ``(pipeline, encode, modules)``; ``encode(prompt)`` gives the
    (cond, uncond) context pair.
    """
    from .conditioning.clip import (CLIPTextConfig, CLIPTextModel,
                                    default_tokenizer)
    from .config import RENDER_PRESETS, denoiser_preset, vae_preset
    from .models.dit import DiT_TriLatent
    from .models.vae import TriplaneVAE

    device = resolve_device(device)
    if den_cfg is None:
        den_cfg = dataclasses.replace(denoiser_preset('t23d-dit-l2'),
                                      exact_gelu=False)
    vae_cfg = vae_cfg or vae_preset('objaverse')
    text_cfg = text_cfg or CLIPTextConfig()
    opts = render_opts or RENDER_PRESETS[
        'objverse_tuneray_aug_resolution_64_64_auto']
    sampler = sampler or SamplerSpec(kind='ddim')
    if sampler.kind not in ('ddim', 'plms', 'dpm'):
        raise ValueError(f'the text→3D checkpoint is a DDPM model: it '
                         f'samples with DDIM, PLMS or DPM-Solver, got '
                         f'sampler kind {sampler.kind!r}')

    if modules is None:
        modules = _random_modules(device, seed, dict(
            denoiser=lambda: DiT_TriLatent(den_cfg),
            vae=lambda: TriplaneVAE(vae_cfg),
            text_model=lambda: CLIPTextModel(text_cfg)))
    denoiser = modules['denoiser'].to(device).to(den_cfg.dtype).eval()
    vae = modules['vae'].to(device).cast_decoder().eval()
    text_model = modules['text_model'].to(device).eval()
    tokenizer = default_tokenizer(max_length=text_cfg.max_length)

    pipeline = _objaverse_pipeline(
        denoiser, vae, opts, render_resolution, sampler, render_dtype,
        device, diffusion=_sampler_diffusion(sampler))

    @torch.no_grad()
    def encode(prompt: str):
        ids = torch.as_tensor(tokenizer([prompt, '']), device=device)
        both = text_model(ids)['last_hidden_state']
        return {'crossattn': both[:1]}, {'crossattn': both[1:]}

    return pipeline, encode, dict(denoiser=denoiser, vae=vae,
                                  text_model=text_model)


def _build_image_family(preset, clip_cfg, dino_cfg, make_encode, device,
                        seed, den_cfg, vae_cfg, render_opts,
                        render_resolution, sampler, transport, render_dtype,
                        modules):
    """The body that the image→3D and multi-view→3D builders share: the
    ``preset`` denoiser with tanh GELU, the Objaverse VAE and render
    options, DINOv2-B/14 in bf16, with ``clip_cfg`` the f32 CLIP vision
    tower, CFG 4.0 on the flow-matching ODE (or a DDPM-family
    ``sampler.kind`` over ``_sampler_diffusion``).  ``make_encode(modules)``
    gives the family's ``encode``."""
    from .conditioning.clip import CLIPVisionModel
    from .config import RENDER_PRESETS, denoiser_preset, vae_preset
    from .models.dit import DiT_TriLatent
    from .models.vae import TriplaneVAE
    from .models.vit import VisionTransformer, vit_registry

    device = resolve_device(device)
    if den_cfg is None:
        den_cfg = dataclasses.replace(denoiser_preset(preset),
                                      exact_gelu=False)
    vae_cfg = vae_cfg or vae_preset('objaverse')
    dino_cfg = dino_cfg or vit_registry('dinov2-b/14', img_size=224,
                                        dtype=torch.bfloat16)
    opts = render_opts or RENDER_PRESETS[
        'objverse_tuneray_aug_resolution_64_64_auto']
    sampler = sampler or SamplerSpec(cfg_scale=4.0)

    if modules is None:
        towers = dict(denoiser=lambda: DiT_TriLatent(den_cfg),
                      vae=lambda: TriplaneVAE(vae_cfg))
        if clip_cfg is not None:
            towers['vision_model'] = lambda: CLIPVisionModel(clip_cfg)
        towers['dino'] = lambda: VisionTransformer(dino_cfg)
        modules = _random_modules(device, seed, towers)
    out = dict(denoiser=modules['denoiser'].to(device).to(den_cfg.dtype),
               vae=modules['vae'].to(device).cast_decoder())
    if clip_cfg is not None:
        out['vision_model'] = modules['vision_model'].to(device)
    out['dino'] = modules['dino'].to(device).to(dino_cfg.dtype)
    for m in out.values():
        m.eval()

    pipeline = _objaverse_pipeline(out['denoiser'], out['vae'], opts,
                                   render_resolution, sampler, render_dtype,
                                   device, transport=transport,
                                   diffusion=_sampler_diffusion(sampler))
    return pipeline, make_encode(out), out


def build_i23d_pipeline(device='cuda', seed: int = 0, den_cfg=None,
                        vae_cfg=None, vision_cfg=None, dino_cfg=None,
                        render_opts=None, render_resolution: int = 192,
                        sampler: Optional[SamplerSpec] = None,
                        transport: Optional[Transport] = None,
                        render_dtype: Optional[torch.dtype] = torch.bfloat16,
                        modules: Optional[dict] = None):
    """The released Objaverse image→3D model on ``device``, as
    ``bench.py`` ``_build_i23d_family`` configures it.

    Defaults: the f32 CLIP ViT-L/14 vision tower and DINOv2-B/14 in bf16
    over one 224² image; DiT-I23D-L/2 (``'image-pixelart'`` blocks with
    the DINO tokens in the self-attention, CLIP tokens in the
    cross-attention, the pooled vector added to t) with tanh GELU in
    bf16; the 250-step Euler ODE of the linear flow-matching path with
    CFG 4.0; then the text→3D path's VAE decode, render and mesh stages.
    Weights are random, drawn from a ``torch.Generator`` seeded with
    ``seed``, unless ``modules`` supplies ``{'denoiser', 'vae',
    'vision_model', 'dino'}``.

    Returns ``(pipeline, encode, modules)``; ``encode(image)``, image (1,
    H, W, 3) in [-1, 1], gives the (cond, uncond) pair through the
    conditioner's CLIP-image and DINO embedders: the CLIP tokens' first
    1024 channels as 'crossattn', the pooled feature's first 768 as
    'vector', DINO's first 257 tokens in f32 as 'dino' (no CLIP or
    ImageNet normalisation, as in the bench), and zeros for uncond.
    """
    from .conditioning.clip import CLIPVisionConfig
    from .conditioning.conditioner import (make_clip_image_embedder,
                                           make_dino_embedder)

    def make_encode(m):
        clip = make_clip_image_embedder(m['vision_model']).encode
        dino = make_dino_embedder(m['dino']).encode

        def encode(image):
            enc = clip(image)
            cond = {'crossattn': enc['crossattn'][:, :, :1024],
                    'vector': enc['vector'][:, :768],
                    'dino': dino(image)['dino'][:, :257].float()}
            return cond, {k: torch.zeros_like(v) for k, v in cond.items()}
        return encode

    return _build_image_family(
        'i23d-pixart-l2', vision_cfg or CLIPVisionConfig(), dino_cfg,
        make_encode, device, seed, den_cfg, vae_cfg, render_opts,
        render_resolution, sampler, transport, render_dtype, modules)


def build_mv23d_pipeline(device='cuda', seed: int = 0, den_cfg=None,
                         vae_cfg=None, dino_cfg=None, render_opts=None,
                         render_resolution: int = 192,
                         sampler: Optional[SamplerSpec] = None,
                         transport: Optional[Transport] = None,
                         render_dtype: Optional[torch.dtype] = torch.bfloat16,
                         modules: Optional[dict] = None):
    """The released Objaverse multi-view→3D model on ``device``, as
    ``bench.py`` ``_build_mv23d_family`` configures it.

    Defaults: DINOv2-B/14 in bf16 over the views; DiT-PixArt-MV-L/2
    (``'mv-pixelart'`` blocks: RMSNorm, q/k RMSNorm, the flattened views'
    DINO tokens in the cross-attention) with tanh GELU in bf16; the
    250-step flow-matching ODE with CFG 4.0; then the VAE decode, render
    and mesh stages.  Weights are random from ``seed`` unless ``modules``
    supplies ``{'denoiser', 'vae', 'dino'}``.

    Returns ``(pipeline, encode, modules)``; ``encode(views)``, views (V,
    H, W, 3) in [-1, 1], gives the (cond, uncond) pair through the
    conditioner's DINO embedder: each view's first 257 DINO tokens
    flattened to (1, V·257, D) in f32 as 'crossattn', and zeros for
    uncond.
    """
    from .conditioning.conditioner import make_dino_embedder

    def make_encode(m):
        dino = make_dino_embedder(m['dino']).encode

        def encode(views):
            tok = dino(views)['dino'][:, :257]
            flat = tok.reshape(1, -1, tok.shape[-1]).float()
            return {'crossattn': flat}, {'crossattn': torch.zeros_like(flat)}
        return encode

    return _build_image_family(
        'mv23d-dit-l2', None, dino_cfg, make_encode, device, seed, den_cfg,
        vae_cfg, render_opts, render_resolution, sampler, transport,
        render_dtype, modules)


# bench.py FAMILY_SPECS / _build_unet_family: CFG scale, pooled-CLIP scale,
# render preset and ray resolution of the two U-Net families
UNET_FAMILIES = {
    'shapenet': dict(cfg_scale=1.0, clip_scale=18.4, ray_res=64,
                     render='shapenet_tuneray_aug_resolution_64_64_'
                            'nearestSR'),
    'ffhq': dict(cfg_scale=6.5, clip_scale=1.0, ray_res=128, render='ffhq'),
}


def build_unet_pipeline(family: str, device='cuda', seed: int = 0,
                        den_cfg=None, vae_cfg=None, text_cfg=None,
                        render_opts=None,
                        render_resolution: Optional[int] = None,
                        sampler: Optional[SamplerSpec] = None,
                        render_dtype: Optional[torch.dtype] = torch.bfloat16,
                        modules: Optional[dict] = None,
                        render_key: str = 'image_sr'):
    """The released ShapeNet (``family='shapenet'``) or FFHQ (``'ffhq'``)
    text→3D model on ``device``, as ``bench.py`` ``_build_unet_family``
    configures it.

    Defaults: the f32 CLIP-L text tower with ``text_projection``; the
    pooled feature L2-normalised × 18.4 (shapenet) or × 1.0 (ffhq) as a
    one-token context; the U-Net-320 LSGM (``denoiser_preset(
    'shapenet-unet')``, bf16) with v-prediction and its mixing logit,
    250-step DDIM (``make_diffusion(steps=1000, mean_type='v',
    mixed_prediction=True, timestep_respacing='ddim250')``), CFG 1.0
    (the conditional half only) or 6.5, ``triplane_scaling_divider`` 1.0;
    the fusionv5 (shapenet) or 4XC_final (ffhq) VAE decoder in bf16 to
    (3, 256, 256, 32) planes, rendered in bf16 through the fused point
    kernel at 64² rays with 64+64 samples + ``NearestConvSR`` to 128², or
    128² rays with 48+48 samples + ``SuperresolutionHybrid8XDC`` to 512²:
    the orbit's frames are ``image_sr`` (``render_key='image_raw'``: the
    renders before the SR head, as the sample script's frames).  The σ
    grid (shapenet's mesh)
    runs through the fused kernel.  Pass the family's orbit as
    ``cameras=orbit_cameras(24, **CAMERA_PRESETS[family])`` and the ray
    resolution as ``render_resolution`` to the call, as the bench does.
    ``den_cfg.quantized`` gives the W8A8 int8 U-Net (``ops/int8.py``).
    Weights are random, drawn from a ``torch.Generator`` seeded with
    ``seed``, unless ``modules`` supplies ``{'denoiser', 'vae',
    'text_model'}`` (a denoiser from ``ops.int8.quantize_unet``, say).

    Returns ``(pipeline, encode, modules)``; ``encode(prompt)`` gives the
    (cond, uncond) pair (the prompt and '')."""
    from .conditioning.clip import (CLIPTextConfig, CLIPTextModel,
                                    default_tokenizer, pooled_text_context)
    from .config import (RENDER_PRESETS, build_vae, denoiser_preset,
                         vae_preset)
    from .models.unet import UNetModel

    spec = UNET_FAMILIES[family]
    device = resolve_device(device)
    den_cfg = den_cfg or denoiser_preset('shapenet-unet')
    vae_cfg = vae_cfg or vae_preset(family)
    text_cfg = text_cfg or CLIPTextConfig(with_projection=True)
    opts = render_opts or RENDER_PRESETS[spec['render']]
    res = render_resolution or spec['ray_res']
    hw = vae_cfg.latent_size
    sampler = sampler or SamplerSpec(
        kind='ddim', num_steps=250, cfg_scale=spec['cfg_scale'],
        triplane_scaling_divider=1.0,
        latent_shape=(hw, hw, vae_cfg.latent_channels))
    if sampler.kind != 'ddim':
        raise ValueError(f'the {family} family samples with DDIM, got '
                         f'sampler kind {sampler.kind!r}')

    if modules is None:
        modules = _random_modules(device, seed, dict(
            denoiser=lambda: UNetModel(den_cfg),
            vae=lambda: build_vae(vae_cfg),
            text_model=lambda: CLIPTextModel(text_cfg)))
    denoiser = modules['denoiser'].to(device).to(den_cfg.dtype).eval()
    vae = modules['vae'].to(device).cast_decoder().eval()
    text_model = modules['text_model'].to(device).eval()
    tokenizer = default_tokenizer(max_length=text_cfg.max_length)

    pipeline = TextTo3DPipeline(
        denoiser,
        vae.decode_latent,
        lambda planes, cam: vae.render(planes, cam, opts, res,
                                       use_fused_osg=True)[render_key],
        lambda planes, coords: vae.query_points(
            planes, coords, opts.box_warp, use_fused_osg=True),
        sampler=sampler,
        diffusion=_sampler_diffusion(sampler, mean_type='v',
                                     mixed_prediction=True),
        mixing_logit=(denoiser.mixing_logit.detach()
                      if den_cfg.mixed_prediction else None),
        render_dtype=render_dtype, device=device)

    @torch.no_grad()
    def encode(prompt: str):
        ids = torch.as_tensor(tokenizer([prompt, '']), device=device)
        both = pooled_text_context(text_model(ids)['text_embeds'],
                                   scale_clip_encoding=spec['clip_scale'])
        return {'crossattn': both[:1]}, {'crossattn': both[1:]}

    return pipeline, encode, dict(denoiser=denoiser, vae=vae,
                                  text_model=text_model)


def build_shapenet_pipeline(device='cuda', **kw):
    """:func:`build_unet_pipeline` for the ShapeNet text→3D release
    (pooled CLIP × 18.4, CFG 1.0, fusionv5 VAE, 24 64²-ray frames +
    ``NearestConvSR`` to 128², 192³ mesh)."""
    return build_unet_pipeline('shapenet', device, **kw)


def build_ffhq_pipeline(device='cuda', **kw):
    """:func:`build_unet_pipeline` for the FFHQ text→3D release (pooled
    CLIP × 1.0, CFG 6.5, 4XC_final VAE, 24 128²-ray frames +
    ``SuperresolutionHybrid8XDC`` to 512², no mesh)."""
    return build_unet_pipeline('ffhq', device, **kw)
