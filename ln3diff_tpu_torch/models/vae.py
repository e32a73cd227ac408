"""Stage-1 triplane VAE: multi-view encoder → KL bottleneck → DiT2 decode
→ planes → volume render and point queries.

Port of ``ln3diff_tpu/models/vae.py`` (``encode`` :180, ``reparameterize``
:194, ``decode_latent`` :213-238, ``_fused_osg`` :245-251, ``render``
:253-306 with the render-space SR heads of :156-178, ``render_rays_flat``
:307, ``__call__`` :328, ``query_points`` :359-378) with the SD encoders
(``encoder_type='sd'``) and the LGM multi-view U-Net encoder
(``encoder_type='lgm'``, ``models/mv_unet.py``).  The SR heads are
``'nearest'`` (``NearestConvSR``), ``'stylegan-8xdc'``
(``SuperresolutionHybrid8XDC``) and ``'stylegan'``
(``SuperresolutionHybrid``), the StyleGAN ones conditioned on ``sr_ws``.
``lrm_decoder`` swaps the point decoder for ``LRMOSGDecoder`` (3 colour
channels; the fused point kernel refuses it, as JAX's ``_fused_osg``
does).  ``use_background`` splits the planes' channels into fg | bg halves,
rendered by ``render/background.py`` with a second point decoder
``bg_decoder`` (the ``'ffhq-fgbg'`` preset).

Latent layout ``(B, h, w, z*3)`` channels-last with plane fastest, and the
absorbed channel interleaves of the reference are reproduced exactly: the
grouped ``ldm_upsample`` consumes the raw z*3+p channels and its
plane-grouped output channels are viewed as (D, plane) with plane fastest.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

from ..ops.fused_render import FusedOSG, fused_osg_from_params
from ..render.background import render_rays_fg_bg
from ..render.ray_sampler import sample_full_rays, unpack_25d_camera
from ..render.renderer import (RenderDraws, RenderOptions, pack_corner_table,
                               packed_gather, project_onto_planes,
                               render_rays, sample_from_planes)
from .dit import DiT2, DiT2Config
from .distributions import make_gaussian
from .mv_unet import LGMMVEncoder, MVUNetConfig
from .osg_decoder import LRMOSGDecoder, OSGDecoder
from .sd_vae import (AutoencoderConfig, Decoder, Encoder, MVEncoder,
                     MVEncoderDynamic)
from .sr import NearestConvSR
from .stylegan import SuperresolutionHybrid, SuperresolutionHybrid8XDC


@dataclasses.dataclass(frozen=True)
class TriplaneVAEConfig:
    """The fields of the JAX ``TriplaneVAEConfig``: the encoder (SD or
    LGM), the bottleneck and the decode side."""
    # encoder
    encoder_in_channels: int = 10      # RGB + 6 Plücker + depth
    encoder_ch: int = 64
    encoder_ch_mult: tuple = (1, 2, 4, 4)
    encoder_res_blocks: int = 1
    img_resolution: int = 256
    num_views: int = 4                 # 0 → mono encoder; >4 → dynamic mean
    # 'sd' (the SD conv MVEncoder of the released archs) or 'lgm' (the LGM
    # MVUNet encoder with joint-view attention)
    encoder_type: str = 'sd'
    lgm_down_channels: tuple = (64, 128, 256, 512)
    lgm_down_attention: tuple = (False, False, True, True)
    # bottleneck
    ldm_z_channels: int = 4            # per-plane latent channels
    latent_size: int = 32              # latent h = w
    dit2: DiT2Config = DiT2Config()
    patch_size: int = 2
    conv_sr_ch: int = 32
    conv_sr_ch_mult: tuple = (1, 2, 2, 4)
    conv_sr_res_blocks: int = 1
    plane_channels: int = 32
    decoder_output_dim: int = 32
    # the LRM point decoder (concatenated planes, 4-layer ReLU MLP, 3
    # colour channels) in place of the OSG decoder; plain PyTorch only
    lrm_decoder: bool = False
    # render-space SR: 'nearest' (NearestConvSR), 'stylegan-8xdc' or
    # 'stylegan' (SuperresolutionHybrid)
    use_sr: bool = False
    sr_ratio: int = 2
    sr_module: str = 'nearest'
    # NeRF++ background: planes split fg | bg by channel, the bg half on
    # inverted-sphere samples composited behind the fg
    use_background: bool = False
    bg_depth_resolution: int = 16
    dtype: Any = torch.float32

    @property
    def plane_resolution(self) -> int:
        up = 2**(len(self.conv_sr_ch_mult) - 1)
        return (self.latent_size // self.patch_size) * up

    @property
    def latent_channels(self) -> int:
        return 3 * self.ldm_z_channels


class TriplaneVAE(nn.Module):
    """The triplane VAE.

    ``encoder=True`` builds the whole autoencoder (training); the default
    builds the decode side only (``ldm_upsample``, ``dit2``, ``conv_sr``,
    ``osg_decoder``), the parameters that JAX's ``init_decoder_paths``
    creates for sampling.

    Parameters are stored in f32.  ``cfg.dtype`` is the compute dtype: the
    trainer runs the encoder and the decoder under autocast to it (the
    renderer and the point decoder stay f32, as in JAX); the serving path
    calls :meth:`cast_decoder` to store the decoder backbone in it (the
    point decoder stays f32, as the fused kernel takes f32 weights).
    """

    def __init__(self, cfg: TriplaneVAEConfig, encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        D = cfg.dit2.hidden_size
        # grouped patch embed (reference PatchEmbedTriplane)
        self.ldm_upsample = nn.Conv2d(
            cfg.latent_channels, 3 * D, cfg.patch_size,
            stride=cfg.patch_size, groups=3)
        self.dit2 = DiT2(cfg.dit2)
        self.conv_sr = Decoder(AutoencoderConfig(
            ch=cfg.conv_sr_ch, ch_mult=tuple(cfg.conv_sr_ch_mult),
            num_res_blocks=cfg.conv_sr_res_blocks, z_channels=D,
            out_ch=cfg.plane_channels, dtype=cfg.dtype))
        point_features = cfg.plane_channels // (2 if cfg.use_background
                                                else 1)
        if cfg.lrm_decoder:
            self.osg_decoder = LRMOSGDecoder(in_features=point_features)
        else:
            self.osg_decoder = OSGDecoder(
                in_features=point_features,
                decoder_output_dim=cfg.decoder_output_dim)
        if cfg.use_background:
            self.bg_decoder = OSGDecoder(
                in_features=point_features,
                decoder_output_dim=cfg.decoder_output_dim)
        self._build_sr_head()
        if encoder:
            self._build_encoder()

    def _build_sr_head(self):
        """The render-space SR head that ``cfg`` asks for (JAX ``setup``
        :156-178)."""
        cfg = self.cfg
        if not cfg.use_sr:
            return
        if cfg.sr_module == 'stylegan-8xdc':
            self.superresolution = SuperresolutionHybrid8XDC(
                cfg.decoder_output_dim)
            # the reference's w_avg buffer, "replaced externally"
            self.sr_ws = nn.Parameter(torch.zeros(512))
        elif cfg.sr_module == 'stylegan':
            self.superresolution = SuperresolutionHybrid(
                cfg.decoder_output_dim, sr_ratio=cfg.sr_ratio)
            # a learned constant style: the VAE has no mapping network
            self.sr_ws = nn.Parameter(torch.randn(512) * 0.02)
        else:
            self.superresolution = NearestConvSR(cfg.decoder_output_dim,
                                                 sr_ratio=cfg.sr_ratio)

    def reset_free_parameters(self, generator=None):
        """``sr_ws`` as JAX initialises it: zeros for the 8XDC head,
        N(0, 0.02²) for the ``'stylegan'`` head."""
        if self.cfg.use_sr and self.cfg.sr_module == 'stylegan':
            self.sr_ws.copy_(torch.randn(
                512, generator=generator, device=self.sr_ws.device) * 0.02)
        elif hasattr(self, 'sr_ws'):
            self.sr_ws.zero_()

    def _build_encoder(self):
        """The encoder chosen as JAX's ``setup`` chooses it
        (``vae.py:104-122``) and the ``quant_conv``."""
        cfg = self.cfg
        enc_cfg = AutoencoderConfig(
            ch=cfg.encoder_ch, ch_mult=tuple(cfg.encoder_ch_mult),
            num_res_blocks=cfg.encoder_res_blocks,
            z_channels=cfg.latent_channels, double_z=True,
            in_channels=cfg.encoder_in_channels,
            resolution=cfg.img_resolution, dtype=cfg.dtype)
        if cfg.encoder_type == 'lgm':
            self.encoder = LGMMVEncoder(
                MVUNetConfig(in_channels=cfg.encoder_in_channels,
                             down_channels=tuple(cfg.lgm_down_channels),
                             down_attention=tuple(cfg.lgm_down_attention),
                             num_frames=max(cfg.num_views, 1)),
                z_channels=cfg.latent_channels, double_z=True)
        elif cfg.num_views == 0:
            self.encoder = Encoder(enc_cfg)
        elif cfg.num_views > 4:
            self.encoder = MVEncoderDynamic(enc_cfg,
                                            num_frames=cfg.num_views)
        else:
            self.encoder = MVEncoder(enc_cfg, num_frames=cfg.num_views)
        # 1x1 conv over the per-plane moment channels, grouped by plane
        # (reference quant_conv, vit_triplane.py:854-857)
        zc = 2 * cfg.latent_channels
        self.quant_conv = nn.Conv2d(zc, zc, 1, groups=3)

    def cast_decoder(self) -> 'TriplaneVAE':
        """Store ``ldm_upsample``, ``dit2``, a ``NearestConvSR`` head and
        ``conv_sr`` in ``cfg.dtype`` (``conv_sr`` in its own config's
        dtype, which the VAE sets to ``cfg.dtype``; serving only: training
        keeps f32 parameters).  The StyleGAN head computes in f32, as in
        JAX."""
        for m in (self.ldm_upsample, self.dit2):
            m.to(self.cfg.dtype)
        self.conv_sr.to(self.conv_sr.cfg.dtype)
        if isinstance(getattr(self, 'superresolution', None), NearestConvSR):
            self.superresolution.to(self.cfg.dtype)
        return self

    # -- encoder ----------------------------------------------------------

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        """``(B·V, H, W, C_in)`` → moments ``(B, h, w, 2z, 3)``.

        The grouped ``quant_conv`` output (plane-major groups) is viewed
        as (2z, plane) with plane fastest, the interleave of the
        reference's ``vae_encode`` (``vit_triplane.py:912-933``) that the
        released weights absorbed."""
        h = self.encoder(imgs)                          # (B, h, w, 6z) NHWC
        moments = self.quant_conv(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        B, hh, ww, _ = moments.shape
        return moments.reshape(B, hh, ww, 2 * self.cfg.ldm_z_channels, 3)

    def reparameterize(self, moments: torch.Tensor,
                       sample_posterior: bool = True,
                       eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """moments ``(B, h, w, 2z, 3)`` → (latent ``(B, h, w, z·3)`` with
        the plane fastest, posterior).  The latent is a sample with ε
        given or drawn from ``generator`` when ``sample_posterior``, else
        the mean (JAX: a sample when a key is given)."""
        z = self.cfg.ldm_z_channels
        posterior = make_gaussian(moments[..., :z, :], moments[..., z:, :],
                                  soft_clamp=True)
        if sample_posterior and (eps is not None or generator is not None):
            latent = posterior.sample(eps=eps, generator=generator)
        else:
            latent = posterior.mode()
        B, hh, ww = latent.shape[:3]
        return latent.reshape(B, hh, ww, z * 3), posterior

    # -- decoder ----------------------------------------------------------

    def decode_latent(self, latent: torch.Tensor) -> torch.Tensor:
        """latent (B, h, w, z*3) → planes (B, 3, Hp, Wp, C)."""
        cfg = self.cfg
        B = latent.shape[0]
        x = latent.permute(0, 3, 1, 2).to(self.ldm_upsample.weight.dtype)
        tok = self.ldm_upsample(x).permute(0, 2, 3, 1)   # (B, th, tw, 3D)
        th, tw = tok.shape[1], tok.shape[2]
        D = cfg.dit2.hidden_size
        # channels viewed as (D, plane) → plane-major tokens
        tok = tok.reshape(B, th * tw, D, 3).permute(0, 3, 1, 2)
        tok = tok.reshape(B, 3 * th * tw, D)
        tok = self.dit2(tok)
        planes = self.conv_sr(tok.reshape(B * 3, th, tw, D))
        Hp, Wp, C = planes.shape[1:]
        return planes.reshape(B, 3, Hp, Wp, C)

    # -- rendering --------------------------------------------------------

    def fused_osg(self) -> FusedOSG:
        """The fused point pipeline built from this module's OSG
        parameters (folded differentiably, so that training through it
        reaches them).  The kernel computes the OSG decoder only: with
        another point decoder (``lrm_decoder``) it raises ``ValueError``,
        as JAX's assert does."""
        if not isinstance(self.osg_decoder, OSGDecoder):
            raise ValueError('fused OSG kernel supports the OSGDecoder arch '
                             'only')
        dec = self.osg_decoder
        return fused_osg_from_params(dict(dec.named_parameters()),
                                     lr_multiplier=dec.decoder_lr_mul,
                                     activation=dec.activation)

    def render(self, planes: torch.Tensor, camera25: Optional[torch.Tensor],
               render_opts: RenderOptions, resolution: int,
               use_fused_osg: bool = False,
               ray_origins: Optional[torch.Tensor] = None,
               ray_directions: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               draws: Optional[RenderDraws] = None,
               apply_sr: bool = True) -> dict:
        """Volume-render planes for 25-dim cameras (full ``resolution²``
        images) or for given square ray bundles.  Sampling is jittered
        when ``draws`` or a ``generator`` is given (see
        :func:`~ln3diff_tpu_torch.render.renderer.render_rays`).  Returns
        image_raw (B, res, res, 3), feature_image, image_depth,
        image_mask and, with an SR head and ``apply_sr``, image_sr (an
        unbounded conv output: ``NearestConvSR`` in the head's dtype, the
        StyleGAN heads in f32).  With ``use_background`` the fg half of
        the planes goes through the two-pass renderer (and kernel 1 with
        ``use_fused_osg``), the bg half through ``bg_decoder``
        (``render_rays_fg_bg``; ``draws`` are the fg pass's).  With
        ``lrm_decoder`` that composite needs ``decoder_output_dim`` = 3,
        the LRM decoder's colour channels; else it raises
        ``ValueError``."""
        if ray_origins is None:
            cam2world, intrinsics = unpack_25d_camera(camera25)
            ray_origins, ray_directions = sample_full_rays(
                cam2world, intrinsics, resolution)
        fused = self.fused_osg() if use_fused_osg else None
        if self.cfg.use_background:
            if (isinstance(self.osg_decoder, LRMOSGDecoder)
                    and self.cfg.decoder_output_dim != 3):
                # JAX fails here on a broadcast of the two decoders' outputs
                raise ValueError(
                    'the fg/bg composite adds the LRM decoder\'s 3 colour '
                    'channels to bg_decoder\'s decoder_output_dim = '
                    f'{self.cfg.decoder_output_dim}: set it to 3')
            out = render_rays_fg_bg(
                planes, self.osg_decoder, self.bg_decoder, ray_origins,
                ray_directions, render_opts,
                bg_depth_resolution=self.cfg.bg_depth_resolution,
                fused_osg=fused, generator=generator, draws=draws)
        else:
            out = render_rays(planes, self.osg_decoder, ray_origins,
                              ray_directions, render_opts, fused_osg=fused,
                              generator=generator, draws=draws)
        B, R = ray_origins.shape[:2]
        res = resolution
        if R != resolution * resolution:
            res = int(round(R**0.5))
            if res * res != R:
                raise ValueError(f'render() needs a square ray bundle '
                                 f'(R={R})')
        feature_image = out.feature_samples.reshape(B, res, res, -1)
        depth_image = out.depth_samples.reshape(B, res, res, 1)
        weights = out.weights_samples.reshape(B, res, res, 1)
        rgb = feature_image[..., :3]
        ret = dict(feature_image=feature_image, image_raw=rgb,
                   image_depth=depth_image,
                   image_mask=weights * 1.002 - 0.001)
        if self.cfg.use_sr and apply_sr:
            if self.cfg.sr_module.startswith('stylegan'):
                ws = self.sr_ws.expand(B, self.sr_ws.shape[0])
                ret['image_sr'] = self.superresolution(feature_image, rgb,
                                                       ws)
            else:
                ret['image_sr'] = self.superresolution(feature_image)
        return ret

    def render_rays_flat(self, planes: torch.Tensor,
                         ray_origins: torch.Tensor,
                         ray_directions: torch.Tensor,
                         render_opts: RenderOptions,
                         use_fused_osg: bool = False) -> torch.Tensor:
        """Render any (B, R) ray bundle → flat features (B, R, C), R not
        necessarily square: no image reshape, so an orbit's frames can
        fold into the ray axis over one set of planes
        (``TextTo3DPipeline.render_orbit`` with ``render_rays_fn``).
        Foreground only, deterministic sampling: a background config
        raises ``ValueError``."""
        if self.cfg.use_background:
            raise ValueError('render_rays_flat renders the foreground '
                             'only; this VAE has background planes')
        return render_rays(planes, self.osg_decoder, ray_origins,
                           ray_directions, render_opts,
                           fused_osg=self.fused_osg() if use_fused_osg
                           else None).feature_samples

    # -- end to end -------------------------------------------------------

    def forward(self, imgs: torch.Tensor, camera25: torch.Tensor,
                render_opts: RenderOptions, resolution: int,
                sample_posterior: bool = True,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                draws: Optional[RenderDraws] = None,
                use_fused_osg: bool = False) -> dict:
        """Full autoencode (JAX ``__call__``): multi-view images → renders
        for ``camera25`` plus ``latent``, ``posterior_kl`` and ``planes``.
        ε and the render's draws come from the arguments or from
        ``generator`` (ε first); with neither, the posterior mean and
        deterministic sampling."""
        moments = self.encode(imgs)
        latent, posterior = self.reparameterize(
            moments, sample_posterior, eps=eps, generator=generator)
        planes = self.decode_latent(latent)
        ret = self.render(planes, camera25, render_opts, resolution,
                          use_fused_osg=use_fused_osg, generator=generator,
                          draws=draws)
        ret.update(latent=latent, posterior_kl=posterior.kl(), planes=planes)
        return ret

    # -- point queries (mesh extraction) ----------------------------------

    def query_points(self, planes: torch.Tensor, coords: torch.Tensor,
                     box_warp: float, use_fused_osg: bool = False):
        """σ/rgb at world coords (B, M, 3) → (rgb, sigma); with
        ``use_background`` from the fg half of the planes."""
        if self.cfg.use_background:
            planes = planes[..., :planes.shape[-1] // 2]
        if use_fused_osg:
            fused = self.fused_osg()
            H, W = planes.shape[2:4]
            packed = pack_corner_table(planes)
            proj = project_onto_planes((2.0 / box_warp) * coords)
            rows, tx, ty, live = packed_gather(packed, proj, H, W)
            return fused(rows, tx, ty, live)
        feats = sample_from_planes(planes, coords, box_warp)
        return self.osg_decoder(feats, None)
