"""StyleGAN2 pieces of the FFHQ render-space SR heads.

Port of ``ln3diff_tpu/models/stylegan.py``: ``setup_filter`` :36,
``upfirdn2d`` :47, ``upsample2d`` :79, ``downsample2d`` :86,
``modulated_conv2d`` :107, the ``'stylegan'`` head of the fg/bg VAE
(``SynthesisLayerLite`` :154, ``ToRGB`` :176, ``SuperresolutionHybrid``
:192), the released 8XDC head (``SynthesisLayerSG2`` :221, ``ToRGBSG2``
:257, ``SynthesisBlockSG2`` :279, ``SuperresolutionHybrid8XDC`` :300;
reference ``nsr/superresolution.py:181-446``), ``filtered_lrelu`` :450 and
``PixelUnshuffleUpsample`` :474.  The functions take NCHW tensors and OIHW
weights (PyTorch's conv layout); the heads take and return channels-last
images, as the JAX modules do, and the StyleGAN heads compute in f32
whatever the caller's dtype.  For the adversarial VAE trainer:
``filtered_resizing`` :93, ``MappingNetwork`` :321 (``w_avg`` a buffer,
truncation), ``minibatch_stddev`` :378, ``DiscriminatorConfig`` :392,
``StyleGANDiscriminator`` :400 and ``DualDiscriminator`` :434 (these take
channels-last images, as the JAX modules do).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import EqualDense

W_DIM = 512          # the w latent's width
CONV_CLAMP = 256.0   # the released head's conv_clamp


def setup_filter(f=(1, 3, 3, 1), normalize: bool = True,
                 device=None) -> torch.Tensor:
    """A 2-D FIR filter, f32: 1-D taps become their outer product
    (computed in f32, as the JAX function does), optionally normalised to
    sum 1.  The default is the released heads' [1, 3, 3, 1] filter."""
    f = np.asarray(f, np.float32)
    if f.ndim == 1:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    return torch.as_tensor(f, device=device)


def upfirdn2d(x: torch.Tensor, f: torch.Tensor, up: int = 1, down: int = 1,
              padding=(0, 0, 0, 0), gain: float = 1.0) -> torch.Tensor:
    """Zero-stuff by ``up`` → pad (px0, px1, py0, py1; negative crops) →
    FIR filter (a convolution: the flipped taps correlated) with gain
    ``gain·up²`` → keep every ``down``-th pixel.  x: (B, C, H, W)."""
    B, C, H, W = x.shape
    if up > 1:
        z = x.new_zeros((B, C, H, up, W, up))
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(B, C, H * up, W * up)
    x = F.pad(x, tuple(padding))
    kernel = torch.flip(f * (gain * up**2), (0, 1)).to(x.dtype)
    x = F.conv2d(x, kernel[None, None].expand(C, 1, *f.shape), groups=C)
    return x[:, :, ::down, ::down] if down > 1 else x


def upsample2d(x: torch.Tensor, f: torch.Tensor, up: int = 2,
               gain: float = 1.0) -> torch.Tensor:
    """FIR upsampling by ``up`` with the padding that keeps the (up·H,
    up·W) size."""
    fh, fw = f.shape
    p = ((fw + up - 1) // 2, (fw - up) // 2, (fh + up - 1) // 2,
         (fh - up) // 2)
    return upfirdn2d(x, f, up=up, padding=p, gain=gain)


def downsample2d(x: torch.Tensor, f: torch.Tensor, down: int = 2,
                 gain: float = 1.0) -> torch.Tensor:
    """FIR downsampling by ``down`` with the padding that gives the (H /
    down, W / down) size."""
    fh, fw = f.shape
    p = ((fw - down + 1) // 2, (fw - down) // 2, (fh - down + 1) // 2,
         (fh - down) // 2)
    return upfirdn2d(x, f, down=down, padding=p, gain=gain)


def filtered_resizing(img: torch.Tensor, size: int, f: torch.Tensor
                      ) -> torch.Tensor:
    """Antialiased resize of NCHW ``img`` to ``size``² (reference
    ``dual_discriminator.py``): FIR up- or downsampling by an integer
    ratio, else the antialiased bilinear resize of ``jax.image.resize``."""
    H = img.shape[2]
    if size == H:
        return img
    if size > H and size % H == 0:
        return upsample2d(img, f, up=size // H)
    if size < H and H % size == 0:
        return downsample2d(img, f, down=H // size)
    return F.interpolate(img, size=(size, size), mode='bilinear',
                         align_corners=False, antialias=True)


def filtered_lrelu(x: torch.Tensor, fu: Optional[torch.Tensor] = None,
                   fd: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None, up: int = 2,
                   down: int = 2, gain: float = math.sqrt(2),
                   slope: float = 0.2, clamp: Optional[float] = None
                   ) -> torch.Tensor:
    """StyleGAN3's antialiased nonlinearity (reference
    ``utils/torch_utils/ops/filtered_lrelu.py``): bias (per channel of
    NCHW ``x``) → FIR upsample by ``up`` → leaky ReLU × ``gain`` → clamp →
    FIR downsample by ``down``; the filters default to the [1, 3, 3, 1]
    taps."""
    fu = setup_filter(device=x.device) if fu is None else fu
    fd = setup_filter(device=x.device) if fd is None else fd
    if bias is not None:
        x = x + bias.to(x.dtype)[:, None, None]
    x = F.leaky_relu(upsample2d(x, fu, up=up), slope) * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return downsample2d(x, fd, down=down)


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor, demodulate: bool = True,
                     up: int = 1) -> torch.Tensor:
    """Style-modulated conv, the batch folded into the groups of one conv.
    x: (B, Cin, H, W); weight: (Cout, Cin, k, k); styles: (B, Cin).

    ``up=2`` (3x3 only): the transposed conv of stride 2 with the
    modulated weight (JAX: the input-dilated conv with the flipped weight
    and padding 2, the same sums) → (2H+1)², then the [1, 3, 3, 1] FIR
    filter with padding (1, 1, 1, 1) and gain 4 → (2H)²."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    w = weight[None] * styles[:, None, :, None, None]       # B Co Ci kh kw
    if demodulate:
        d = torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)
        w = w * d[:, :, None, None, None]
    xg = x.reshape(1, B * Cin, H, W)
    if up == 1:
        out = F.conv2d(xg, w.reshape(B * Cout, Cin, kh, kw),
                       padding=(kh // 2, kw // 2), groups=B)
        return out.reshape(B, Cout, H, W)
    if up != 2 or kh != 3 or kw != 3:
        raise ValueError(f'modulated_conv2d: up={up} needs up=2 and a 3x3 '
                         f'weight, got {kh}x{kw}')
    wt = w.transpose(1, 2).reshape(B * Cin, Cout, kh, kw)
    out = F.conv_transpose2d(xg, wt, stride=2, groups=B)
    out = out.reshape(B, Cout, out.shape[2], out.shape[3])
    return upfirdn2d(out, setup_filter(device=x.device),
                     padding=(1, 1, 1, 1), gain=float(up * up))


class SynthesisLayerLite(nn.Module):
    """Modulated conv (optional 2x up) + bias + leaky ReLU (0.2) × √2, no
    noise and no clamp: the layer of ``SuperresolutionHybrid``.  Its raw
    weight is scaled by 1/√(Cin·k²) before the modulation."""

    def __init__(self, in_channels: int, out_channels: int, up: int = 1,
                 kernel: int = 3):
        super().__init__()
        self.up = up
        self.affine = EqualDense(W_DIM, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(
            torch.randn(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_free_parameters(self, generator=None):
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=self.weight.device))

    def forward(self, x, w_latent):
        styles = self.affine(w_latent.float())
        cin, k = self.weight.shape[1], self.weight.shape[2]
        weight = self.weight.float() * (1.0 / math.sqrt(cin * k * k))
        y = modulated_conv2d(x.float(), weight, styles, up=self.up)
        y = F.leaky_relu(y + self.bias.float()[:, None, None], 0.2)
        return y * math.sqrt(2)


class ToRGB(nn.Module):
    """1x1 modulated conv without demodulation (the weight scaled by
    1/√Cin) + bias: the skip of ``SuperresolutionHybrid``."""

    def __init__(self, in_channels: int, out_channels: int = 3):
        super().__init__()
        self.affine = EqualDense(W_DIM, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_free_parameters(self, generator=None):
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=self.weight.device))

    def forward(self, x, w_latent):
        styles = self.affine(w_latent.float())
        weight = self.weight.float() / math.sqrt(self.weight.shape[1])
        y = modulated_conv2d(x.float(), weight, styles, demodulate=False)
        return y + self.bias.float()[:, None, None]


class SuperresolutionHybrid(nn.Module):
    """The ``'stylegan'`` render-space SR head (reference
    ``SuperresolutionHybrid4X``-style, ``nsr/superresolution.py:181-446``):
    log2(``sr_ratio``) blocks, each a 2x-up and a plain
    ``SynthesisLayerLite`` of ``hidden`` channels with the rgb skip
    FIR-upsampled plus ``ToRGB``.  Inputs: the feature image (B, H, W, C),
    its rgb (B, H, W, 3) and w latents (B, 512); returns the (B, sr·H,
    sr·W, 3) rgb in f32."""

    def __init__(self, in_channels: int = 32, sr_ratio: int = 4,
                 hidden: int = 128):
        super().__init__()
        self.n_blocks = int(math.log2(sr_ratio))
        cin = in_channels
        for i in range(self.n_blocks):
            self.add_module(f'conv0_{i}', SynthesisLayerLite(cin, hidden,
                                                             up=2))
            self.add_module(f'conv1_{i}', SynthesisLayerLite(hidden, hidden))
            self.add_module(f'torgb_{i}', ToRGB(hidden))
            cin = hidden

    def forward(self, feature_image, rgb_image, ws):
        x = feature_image.permute(0, 3, 1, 2).float()
        rgb = rgb_image.permute(0, 3, 1, 2).float()
        f = setup_filter(device=x.device)
        for i in range(self.n_blocks):
            x = getattr(self, f'conv0_{i}')(x, ws)
            x = getattr(self, f'conv1_{i}')(x, ws)
            rgb = upsample2d(rgb, f) + getattr(self, f'torgb_{i}')(x, ws)
        return rgb.permute(0, 2, 3, 1)


class SynthesisLayerSG2(nn.Module):
    """StyleGAN2 ``SynthesisLayer``: affine style from a ``w_dim`` latent,
    modulated conv (optional 2x up with the FIR), bias, leaky ReLU (0.2) ×
    √2, clamp to ±256.  The constant noise input is carried for the
    weights; ``noise_mode='none'`` (the released SR head, the EG3D
    backbone) does not add it."""

    def __init__(self, in_channels: int, out_channels: int, resolution: int,
                 up: int = 1, w_dim: int = W_DIM):
        super().__init__()
        self.up = up
        self.affine = EqualDense(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(
            torch.randn(out_channels, in_channels, 3, 3))
        self.noise_strength = nn.Parameter(torch.zeros(()))
        self.noise_const = nn.Parameter(torch.randn(resolution, resolution))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_free_parameters(self, generator=None):
        for p in (self.weight, self.noise_const):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device))
        self.noise_strength.zero_()

    def forward(self, x, w_latent):
        styles = self.affine(w_latent.float())
        y = modulated_conv2d(x.float(), self.weight.float(), styles,
                             up=self.up)
        y = F.leaky_relu(y + self.bias.float()[:, None, None], 0.2)
        return (y * math.sqrt(2)).clamp(-CONV_CLAMP, CONV_CLAMP)


class ToRGBSG2(nn.Module):
    """StyleGAN2 ``ToRGBLayer`` to ``out_channels`` (3; the EG3D backbone
    96): styles from a ``w_dim`` latent / √Cin, 1x1 modulated conv without
    demodulation, bias, clamp to ±256."""

    def __init__(self, in_channels: int, out_channels: int = 3,
                 w_dim: int = W_DIM):
        super().__init__()
        self.affine = EqualDense(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_free_parameters(self, generator=None):
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=self.weight.device))

    def forward(self, x, w_latent):
        styles = self.affine(w_latent.float()) / math.sqrt(x.shape[1])
        y = modulated_conv2d(x.float(), self.weight.float(), styles,
                             demodulate=False)
        return (y + self.bias.float()[:, None, None]).clamp(-CONV_CLAMP,
                                                             CONV_CLAMP)


class SynthesisBlockSG2(nn.Module):
    """Skip-architecture ``SynthesisBlock``: conv0 (2x up) → conv1, the
    image skip (``img_channels`` wide; None: none yet) FIR-upsampled plus
    ToRGB.  (x, img) NCHW → (x, img) at twice the resolution."""

    def __init__(self, in_channels: int, out_channels: int,
                 resolution: int, img_channels: int = 3, w_dim: int = W_DIM):
        super().__init__()
        self.conv0 = SynthesisLayerSG2(in_channels, out_channels, resolution,
                                       up=2, w_dim=w_dim)
        self.conv1 = SynthesisLayerSG2(out_channels, out_channels,
                                       resolution, w_dim=w_dim)
        self.torgb = ToRGBSG2(out_channels, img_channels, w_dim=w_dim)

    def forward(self, x, img, w_latent):
        x = self.conv1(self.conv0(x, w_latent), w_latent)
        y = self.torgb(x, w_latent)
        if img is None:
            return x, y
        img = upsample2d(img.float(), setup_filter(device=x.device))
        return x, img + y


class SuperresolutionHybrid8XDC(nn.Module):
    """The released FFHQ SR head: bilinear resize to 128² (only when the
    input is not 128²) → SynthesisBlock(→256 channels @ 256²) →
    SynthesisBlock(→128 @ 512²); returns the 512² rgb skip (B, 512, 512,
    3), in f32.  Inputs: the feature image (B, H, W, C), its rgb (B, H, W,
    3) and w latents (B, 512)."""

    def __init__(self, in_channels: int = 32):
        super().__init__()
        self.block0 = SynthesisBlockSG2(in_channels, 256, 256)
        self.block1 = SynthesisBlockSG2(256, 128, 512)

    def forward(self, feature_image, rgb_image, ws):
        x = feature_image.permute(0, 3, 1, 2).float()
        rgb = rgb_image.permute(0, 3, 1, 2).float()
        if x.shape[2] != 128:
            # the reference's antialiased bilinear resize (jax.image.resize)
            x, rgb = (F.interpolate(t, size=(128, 128), mode='bilinear',
                                    align_corners=False, antialias=True)
                      for t in (x, rgb))
        x, rgb = self.block0(x, rgb, ws)
        x, rgb = self.block1(x, rgb, ws)
        return rgb.permute(0, 2, 3, 1)


class PixelUnshuffleUpsample(nn.Module):
    """Pixel-shuffle SR head (reference ``utils/torch_utils/
    components.py:323-344``): conv (+ the input as a skip) → conv to
    ``num_feat`` + leaky ReLU (0.01) → per 2x stage a conv to 4·num_feat
    and a depth-to-space with the JAX module's channel order (r_h, r_w,
    feat) → conv to ``num_out_ch``.  Channels-last in and out; the input
    is cast to the layers' dtype."""

    def __init__(self, in_channels: int, num_feat: int = 128,
                 num_out_ch: int = 3, sr_ratio: int = 2):
        super().__init__()
        self.num_feat = num_feat
        self.stages = int(math.log2(sr_ratio))
        self.conv_after_body = nn.Conv2d(in_channels, in_channels, 3,
                                         padding=1)
        self.conv_before_upsample = nn.Conv2d(in_channels, num_feat, 3,
                                              padding=1)
        for i in range(self.stages):
            self.add_module(f'up_conv_{i}', nn.Conv2d(num_feat, 4 * num_feat,
                                                      3, padding=1))
        self.conv_last = nn.Conv2d(num_feat, num_out_ch, 3, padding=1)

    def forward(self, x, input_skip_connection: bool = True):
        x = x.permute(0, 3, 1, 2).to(self.conv_last.weight.dtype)
        h = self.conv_after_body(x)
        x = h + x if input_skip_connection else h
        x = F.leaky_relu(self.conv_before_upsample(x), 0.01)
        for i in range(self.stages):
            x = getattr(self, f'up_conv_{i}')(x)
            B, _, H, W = x.shape
            x = x.reshape(B, 2, 2, self.num_feat, H, W)
            x = x.permute(0, 3, 4, 1, 5, 2).reshape(B, self.num_feat, 2 * H,
                                                    2 * W)
        return self.conv_last(x).permute(0, 2, 3, 1)


class MappingNetwork(nn.Module):
    """z (and an optional label c) → w latents (reference
    ``nsr/networks_stylegan2.py:246-334``): second-moment-normalised
    inputs, ``num_layers`` equalized-lr FCs at ``lr_multiplier`` with
    leaky ReLU (0.2) × √2, broadcast to ``num_ws``.  ``w_avg`` (the JAX
    module's 'stats' collection) is a buffer: ``update_emas`` moves it
    toward the batch's mean w before the truncation reads it."""

    def __init__(self, z_dim: int = 512, c_dim: int = 0, w_dim: int = 512,
                 num_ws: Optional[int] = 14, num_layers: int = 8,
                 lr_multiplier: float = 0.01, w_avg_beta: float = 0.998):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.num_ws, self.num_layers = num_ws, num_layers
        self.w_avg_beta = w_avg_beta
        if c_dim > 0:
            self.embed = EqualDense(c_dim, w_dim)
        cin = (z_dim if z_dim > 0 else 0) + (w_dim if c_dim > 0 else 0)
        for i in range(num_layers):
            self.add_module(f'fc{i}', EqualDense(cin if i == 0 else w_dim,
                                                 w_dim, lr_multiplier))
        self.register_buffer('w_avg', torch.zeros(w_dim))

    def forward(self, z, c=None, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_emas: bool = False):
        def norm2(v):
            return v * torch.rsqrt(v.square().mean(-1, keepdim=True) + 1e-8)

        parts = []
        if self.z_dim > 0:
            parts.append(norm2(z.float()))
        if self.c_dim > 0:
            parts.append(norm2(self.embed(c.float())))
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
        for i in range(self.num_layers):
            x = F.leaky_relu(getattr(self, f'fc{i}')(x), 0.2) * math.sqrt(2)
        if update_emas:
            with torch.no_grad():
                mean = x.detach().mean(0)
                self.w_avg.copy_(mean + self.w_avg_beta
                                 * (self.w_avg - mean))
        if self.num_ws is not None:
            x = x[:, None].expand(x.shape[0], self.num_ws, self.w_dim)
        if truncation_psi != 1.0:
            w_avg = self.w_avg
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + truncation_psi * (x - w_avg)
            else:
                head = w_avg + truncation_psi * (
                    x[:, :truncation_cutoff] - w_avg)
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


def minibatch_stddev(x: torch.Tensor, group_size: int = 4) -> torch.Tensor:
    """One channel more on NCHW ``x``: the std over each group of samples
    (the largest size ≤ ``group_size`` dividing B; sample b in group
    member b // (B/g)), averaged over C, H and W."""
    B, C, H, W = x.shape
    g = min(group_size, B)
    while B % g:
        g -= 1
    y = x.reshape(g, B // g, C, H, W)
    y = y - y.mean(dim=0, keepdim=True)
    y = torch.sqrt(y.square().mean(dim=0) + 1e-8)
    y = y.mean(dim=(1, 2, 3), keepdim=True)             # (B//g, 1, 1, 1)
    y = y.repeat(g, 1, H, W)
    return torch.cat([x, y], dim=1)


@dataclasses.dataclass(frozen=True)
class DiscriminatorConfig:
    img_resolution: int = 128
    img_channels: int = 3
    base_channels: int = 64
    max_channels: int = 512
    dtype: Any = torch.float32


class StyleGANDiscriminator(nn.Module):
    """Residual conv discriminator with minibatch stddev (reference
    ``nsr/dual_discriminator.py``, ``nsr/losses/disc.py``): a 1x1
    ``from_rgb``, log2(res) − 2 blocks (a FIR-downsampled 1x1 skip, a 3x3
    conv, a stride-2 3x3 conv, (lrelu + skip)/√2), the stddev channel, a
    3x3 conv and two dense layers.  Images (B, H, W, C) channels-last →
    logits (B, 1), computed under autocast to ``cfg.dtype`` over f32
    parameters.  The stride-2 convs pad (0, 1) as 'SAME' does on an even
    input, not (1, 1)."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig()):
        super().__init__()
        self.cfg = cfg
        self.n_down = int(math.log2(cfg.img_resolution)) - 2
        ch = cfg.base_channels
        self.from_rgb = nn.Conv2d(cfg.img_channels, ch, 1)
        for i in range(self.n_down):
            cout = min(ch * 2, cfg.max_channels)
            self.add_module(f'skip_{i}', nn.Conv2d(ch, cout, 1, bias=False))
            self.add_module(f'conv0_{i}', nn.Conv2d(ch, ch, 3, padding=1))
            self.add_module(f'conv1_{i}', nn.Conv2d(ch, cout, 3, stride=2))
            ch = cout
        self.final_conv = nn.Conv2d(ch + 1, ch, 3, padding=1)
        side = cfg.img_resolution >> self.n_down
        self.fc = nn.Linear(ch * side * side, ch)
        self.out = nn.Linear(ch, 1)
        self.register_buffer('fir', setup_filter(), persistent=False)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        with torch.autocast(img.device.type, dtype=dt,
                            enabled=dt != torch.float32):
            x = img.permute(0, 3, 1, 2).to(self.from_rgb.weight.dtype)
            x = F.leaky_relu(self.from_rgb(x), 0.2)
            for i in range(self.n_down):
                y = getattr(self, f'skip_{i}')(downsample2d(x, self.fir))
                x = F.leaky_relu(getattr(self, f'conv0_{i}')(x), 0.2)
                x = getattr(self, f'conv1_{i}')(F.pad(x, (0, 1, 0, 1)))
                x = (F.leaky_relu(x, 0.2) + y) / math.sqrt(2)
            x = minibatch_stddev(x)
            x = F.leaky_relu(self.final_conv(x), 0.2)
            # flatten in the channels-last order of the JAX module's fc
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = F.leaky_relu(self.fc(x), 0.2)
            return self.out(x)


class DualDiscriminator(nn.Module):
    """EG3D dual discriminator (reference ``nsr/dual_discriminator.py:
    22-180``): the raw render, filter-resized to the SR image's size, is
    concatenated to the SR image (channels-last, SR first) for a
    ``StyleGANDiscriminator`` of twice the channels, ``d``."""

    def __init__(self, cfg: DiscriminatorConfig = DiscriminatorConfig()):
        super().__init__()
        self.d = StyleGANDiscriminator(dataclasses.replace(
            cfg, img_channels=2 * cfg.img_channels))
        self.register_buffer('fir', setup_filter(), persistent=False)

    def forward(self, img_sr: torch.Tensor, img_raw: torch.Tensor
                ) -> torch.Tensor:
        raw = filtered_resizing(img_raw.permute(0, 3, 1, 2).float(),
                                img_sr.shape[1], self.fir)
        x = torch.cat([img_sr.float(), raw.permute(0, 2, 3, 1)], dim=-1)
        return self.d(x)
