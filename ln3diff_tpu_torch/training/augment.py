"""Adaptive discriminator augmentation (ADA), the StyleGAN2-ADA
pipeline.

Port of ``ln3diff_tpu/training/augment.py`` (``_filter_bank`` :57,
``AugmentConfig`` :79, ``bgc_config`` :133, ``augment_pipe`` :207,
``_execute_geometric`` :398, ``update_ada_p`` :439; reference
``nsr/augment.py``): one function of the images, the config and the
strength ``p``.  The geometric transforms compose into one inverse 3x3
affine per image, run as a reflect pad by ``dim − 1``, a sym6 FIR 2x
upsample, one bilinear warp and a FIR 2x downsample; the colour
transforms compose into one 4x4 matrix; image-space filtering is a
per-image separable FIR over reflect-padded images; then noise and
cutout.  ``debug_percentile`` replaces every random parameter by its
percentile, as the reference's mode does.

Randomness: JAX draws from ``split(key, 48)``, one key per call in a
fixed order (a gate's key is taken even in the ``debug_percentile`` mode,
which then draws nothing from it).  :class:`AugmentDraws` holds the draws
by that key index, so a test can feed JAX's; without them they come from
a ``torch.Generator``.  ``augment_draw_plan`` lists (index, 'uniform' or
'normal', shape) of every draw of a call.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.stylegan import setup_filter, upfirdn2d, upsample2d

# orthogonal wavelet taps (symlets)
_SYM2 = np.array([-0.12940952255092145, 0.22414386804185735,
                  0.836516303737469, 0.48296291314469025])
_SYM6 = np.array([
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
])
_LUMA = np.array([1.0, 1.0, 1.0, 0.0]) / np.sqrt(3.0)
_NUM_KEYS = 48


def _filter_bank(num_bands: int = 4) -> np.ndarray:
    """The wavelet band filters of image-space filtering: band 0 the
    lowpass autocorrelation, each further band the highpass one octave
    down (rows are symmetric FIR kernels)."""
    lo = _SYM2
    hi = lo * ((-1.0) ** np.arange(lo.size))
    lo2 = np.convolve(lo, lo[::-1]) / 2.0
    hi2 = np.convolve(hi, hi[::-1]) / 2.0
    bank = np.eye(num_bands, 1)
    for i in range(1, num_bands):
        dilated = np.zeros((num_bands, bank.shape[1] * 2 - 1))
        dilated[:, ::2] = bank
        bank = np.stack([np.convolve(row, lo2) for row in dilated])
        lo_off = (bank.shape[1] - hi2.size) // 2
        bank[i, lo_off:lo_off + hi2.size] += hi2
    return bank.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Probability multipliers and parameter ranges (the reference's
    defaults).  A multiplier of 0 removes the augmentation; the
    per-image probability is ``multiplier·p``."""
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    imgfilter: float = 0.0
    imgfilter_bands: tuple = (1.0, 1.0, 1.0, 1.0)
    imgfilter_std: float = 1.0
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5

    @property
    def any_geometric(self) -> bool:
        return max(self.xflip, self.rotate90, self.xint, self.scale,
                   self.rotate, self.aniso, self.xfrac) > 0

    @property
    def any_color(self) -> bool:
        return max(self.brightness, self.contrast, self.lumaflip,
                   self.hue, self.saturation) > 0


def bgc_config() -> AugmentConfig:
    """blit + geometric + colour: the standard ADA 'bgc' preset."""
    return AugmentConfig(xflip=1, rotate90=1, xint=1, scale=1, rotate=1,
                         aniso=1, xfrac=1, brightness=1, contrast=1,
                         lumaflip=1, hue=1, saturation=1)


@dataclasses.dataclass
class AugmentDraws:
    """The draws of one ``augment_pipe`` call by JAX's key index (0-47):
    ``values[i]`` is ``uniform`` or ``normal`` of ``split(key, 48)[i]``
    in the shape ``augment_draw_plan`` gives (channels-last for the pixel
    noise)."""
    values: dict


class _Source:
    """Hands out the draws in JAX's key order: from ``draws``, or from
    ``generator``; records the plan."""

    def __init__(self, draws: Optional[AugmentDraws], generator, device):
        self.draws, self.generator, self.device = draws, generator, device
        self.index = 0
        self.plan = []

    def _next(self, kind, shape):
        i = self.index
        self.index += 1
        if i >= _NUM_KEYS:
            raise RuntimeError('augment_pipe needs more than 48 keys')
        self.plan.append((i, kind, tuple(shape)))
        if self.draws is not None:
            v = self.draws.values[i].to(self.device, torch.float32)
            if tuple(v.shape) != tuple(shape):
                raise ValueError(f'draw {i}: shape {tuple(v.shape)}, the '
                                 f'pipe needs {tuple(shape)}')
            return v
        fn = torch.rand if kind == 'uniform' else torch.randn
        return fn(tuple(shape), generator=self.generator,
                  device=self.device)

    def uniform(self, *shape):
        return self._next('uniform', shape)

    def normal(self, *shape):
        return self._next('normal', shape)

    def skip(self):
        """A key taken without a draw (a gate under debug_percentile)."""
        self.index += 1


def _eye(n, B, device):
    return torch.eye(n, device=device).expand(B, n, n).clone()


def _t2d(tx, ty):
    m = _eye(3, tx.shape[0], tx.device)
    m[:, 0, 2], m[:, 1, 2] = tx, ty
    return m


def _s2d(sx, sy):
    m = _eye(3, sx.shape[0], sx.device)
    m[:, 0, 0], m[:, 1, 1] = sx, sy
    return m


def _r2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(3, theta.shape[0], theta.device)
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1] = c, -s, s, c
    return m


def _const(v, B, device):
    return torch.full((B,), v, device=device)


def _rotate3d_luma(theta):
    """Rotation of RGB space around the luma axis (homogeneous 4x4)."""
    vx, vy, vz = (float(v) for v in _LUMA[:3])
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1.0 - c
    m = torch.zeros(theta.shape + (4, 4), device=theta.device)
    rows = [
        (0, 0, vx * vx * cc + c), (0, 1, vx * vy * cc - vz * s),
        (0, 2, vx * vz * cc + vy * s),
        (1, 0, vy * vx * cc + vz * s), (1, 1, vy * vy * cc + c),
        (1, 2, vy * vz * cc - vx * s),
        (2, 0, vz * vx * cc - vy * s), (2, 1, vz * vy * cc + vx * s),
        (2, 2, vz * vz * cc + c),
    ]
    for i, j, val in rows:
        m[..., i, j] = val
    m[..., 3, 3] = 1.0
    return m


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """numpy's 'reflect' indices of a pad by ``pad`` on each side of a
    length-``n`` axis, also when ``pad >= n`` (the reflection repeats
    with period 2(n − 1))."""
    i = torch.arange(-pad, n + pad, device=device).remainder(2 * (n - 1))
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """``jnp.pad(mode='reflect')`` of NCHW ``x`` by ``pad`` on H and W."""
    H, W = x.shape[2:]
    x = x.index_select(2, _reflect_index(H, pad, x.device))
    return x.index_select(3, _reflect_index(W, pad, x.device))


def _erfinv(v: float) -> float:
    """erfinv in f32 (the debug percentiles; JAX evaluates it in f32)."""
    return float(torch.erfinv(torch.tensor(v, dtype=torch.float32)))


def augment_pipe(images: torch.Tensor, cfg: AugmentConfig, p,
                 debug_percentile: Optional[float] = None,
                 draws: Optional[AugmentDraws] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """The ADA pipeline on images (B, H, W, C), C ∈ {1, 3}, any float
    dtype; returns them augmented, same shape and dtype.  ``p``: the
    global strength (a float or a 0-d tensor).  The draws come from
    ``draws`` or ``generator``."""
    out, _ = _augment(images, cfg, p, debug_percentile, draws, generator)
    return out


def augment_draw_plan(shape, cfg: AugmentConfig,
                      debug_percentile: Optional[float] = None) -> list:
    """(key index, 'uniform' | 'normal', shape) of every draw that
    ``augment_pipe`` makes on images of ``shape`` (B, H, W, C)."""
    _, plan = _augment(torch.zeros(shape), cfg, 0.0, debug_percentile,
                       None, torch.Generator().manual_seed(0))
    return plan


def _augment(images, cfg, p, dp, draws, generator):
    B, H, W, C = images.shape
    dev = images.device
    in_dtype = images.dtype
    src = _Source(draws, generator, dev)
    x = images.float().permute(0, 3, 1, 2)          # NCHW inside

    def gate(mult, prob, value, identity, dp_value):
        """``value`` with probability ``mult·prob``, else ``identity``;
        the percentile's ``dp_value`` under ``debug_percentile``."""
        if dp is not None:
            src.skip()
            return dp_value
        u = src.uniform(*value.shape)
        return torch.where(u < mult * prob, value, identity)

    # ---- geometric: compose the inverse pixel-space affine -------------
    if cfg.any_geometric:
        g = _eye(3, B, dev)
        if cfg.xflip > 0:
            i = torch.floor(src.uniform(B) * 2)
            i = gate(cfg.xflip, p, i, torch.zeros_like(i),
                     _const(math.floor(dp * 2) if dp is not None else 0.0,
                            B, dev))
            g = g @ _s2d(1.0 / (1 - 2 * i), torch.ones_like(i))
        if cfg.rotate90 > 0:
            i = torch.floor(src.uniform(B) * 4)
            i = gate(cfg.rotate90, p, i, torch.zeros_like(i),
                     _const(math.floor(dp * 4) if dp is not None else 0.0,
                            B, dev))
            g = g @ _r2d(np.pi / 2 * i)
        if cfg.xint > 0:
            t = (src.uniform(B, 2) * 2 - 1) * cfg.xint_max
            t = gate(cfg.xint, p, t, torch.zeros_like(t), torch.full(
                (B, 2), (dp * 2 - 1) * cfg.xint_max if dp is not None
                else 0.0, device=dev))
            g = g @ _t2d(-torch.round(t[:, 0] * W),
                         -torch.round(t[:, 1] * H))
        if cfg.scale > 0:
            s = torch.exp2(src.normal(B) * cfg.scale_std)
            s = gate(cfg.scale, p, s, torch.ones_like(s), _const(
                2.0 ** (_erfinv(dp * 2 - 1) * cfg.scale_std)
                if dp is not None else 1.0, B, dev))
            g = g @ _s2d(1.0 / s, 1.0 / s)
        # pre and post rotation each fire with p_rot: P(pre or post) = p
        p_rot = 1 - torch.sqrt(torch.clamp(torch.as_tensor(
            1 - cfg.rotate * p, dtype=torch.float32, device=dev), 0, 1))
        if cfg.rotate > 0:
            th = (src.uniform(B) * 2 - 1) * np.pi * cfg.rotate_max
            th = gate(1.0, p_rot, th, torch.zeros_like(th), _const(
                (dp * 2 - 1) * np.pi * cfg.rotate_max if dp is not None
                else 0.0, B, dev))
            g = g @ _r2d(th)
        if cfg.aniso > 0:
            s = torch.exp2(src.normal(B) * cfg.aniso_std)
            s = gate(cfg.aniso, p, s, torch.ones_like(s), _const(
                2.0 ** (_erfinv(dp * 2 - 1) * cfg.aniso_std)
                if dp is not None else 1.0, B, dev))
            g = g @ _s2d(1.0 / s, s)
        if cfg.rotate > 0:
            th = (src.uniform(B) * 2 - 1) * np.pi * cfg.rotate_max
            th = gate(1.0, p_rot, th, torch.zeros_like(th),
                      torch.zeros(B, device=dev))
            g = g @ _r2d(th)
        if cfg.xfrac > 0:
            t = src.normal(B, 2) * cfg.xfrac_std
            t = gate(cfg.xfrac, p, t, torch.zeros_like(t), torch.full(
                (B, 2), _erfinv(dp * 2 - 1) * cfg.xfrac_std
                if dp is not None else 0.0, device=dev))
            g = g @ _t2d(-t[:, 0] * W, -t[:, 1] * H)
        x = _execute_geometric(x, g)

    # ---- colour: one homogeneous 4x4 per image ---------------------------
    if cfg.any_color:
        cmat = _eye(4, B, dev)
        eye4 = torch.eye(4, device=dev)
        if cfg.brightness > 0:
            b = src.normal(B) * cfg.brightness_std
            b = gate(cfg.brightness, p, b, torch.zeros_like(b), _const(
                _erfinv(dp * 2 - 1) * cfg.brightness_std
                if dp is not None else 0.0, B, dev))
            t = _eye(4, B, dev)
            t[:, 0, 3], t[:, 1, 3], t[:, 2, 3] = b, b, b
            cmat = t @ cmat
        if cfg.contrast > 0:
            c = torch.exp2(src.normal(B) * cfg.contrast_std)
            c = gate(cfg.contrast, p, c, torch.ones_like(c), _const(
                2.0 ** (_erfinv(dp * 2 - 1) * cfg.contrast_std)
                if dp is not None else 1.0, B, dev))
            t = _eye(4, B, dev)
            t[:, 0, 0], t[:, 1, 1], t[:, 2, 2] = c, c, c
            cmat = t @ cmat
        vv = torch.as_tensor(np.outer(_LUMA, _LUMA), dtype=torch.float32,
                             device=dev)
        if cfg.lumaflip > 0:
            i = torch.floor(src.uniform(B, 1, 1) * 2)
            i = gate(cfg.lumaflip, p, i, torch.zeros_like(i), torch.full(
                (B, 1, 1), math.floor(dp * 2) if dp is not None else 0.0,
                device=dev))
            cmat = (eye4 - 2.0 * vv * i) @ cmat     # Householder
        if cfg.hue > 0 and C > 1:
            th = (src.uniform(B) * 2 - 1) * np.pi * cfg.hue_max
            th = gate(cfg.hue, p, th, torch.zeros_like(th), _const(
                (dp * 2 - 1) * np.pi * cfg.hue_max if dp is not None
                else 0.0, B, dev))
            cmat = _rotate3d_luma(th) @ cmat
        if cfg.saturation > 0 and C > 1:
            s = torch.exp2(src.normal(B, 1, 1) * cfg.saturation_std)
            s = gate(cfg.saturation, p, s, torch.ones_like(s), torch.full(
                (B, 1, 1), 2.0 ** (_erfinv(dp * 2 - 1) * cfg.saturation_std)
                if dp is not None else 1.0, device=dev))
            cmat = (vv + (eye4 - vv) * s) @ cmat
        if C == 3:
            x = (torch.einsum('bij,bjhw->bihw', cmat[:, :3, :3], x)
                 + cmat[:, :3, 3][:, :, None, None])
        elif C == 1:
            cm = cmat[:, :3, :].mean(dim=1)                 # (B, 4)
            x = (x * cm[:, :3].sum(-1)[:, None, None, None]
                 + cm[:, 3][:, None, None, None])
        else:
            raise ValueError('colour transforms need 1 or 3 channels')

    # ---- image-space filtering ------------------------------------------
    if cfg.imgfilter > 0:
        if len(cfg.imgfilter_bands) != 4:
            raise ValueError('the expected-power table is for 4 bands')
        fbank = torch.as_tensor(_filter_bank(4), device=dev)
        num_bands, taps = fbank.shape
        expected = torch.as_tensor(np.array([10, 1, 1, 1], np.float32) / 13,
                                   device=dev)
        gain = torch.ones((B, num_bands), device=dev)
        for i, band in enumerate(cfg.imgfilter_bands):
            t_i = torch.exp2(src.normal(B) * cfg.imgfilter_std)
            t_i = gate(cfg.imgfilter * band, p, t_i, torch.ones_like(t_i),
                       _const(2.0 ** (_erfinv(dp * 2 - 1)
                                      * cfg.imgfilter_std)
                              if (dp is not None and band > 0) else 1.0,
                              B, dev))
            t = torch.ones((B, num_bands), device=dev)
            t[:, i] = t_i
            t = t / torch.sqrt((expected * t**2).sum(-1, keepdim=True))
            gain = gain * t
        kern = (gain @ fbank).repeat_interleave(C, dim=0)   # (B·C, taps)
        pad = taps // 2
        xf = _reflect_pad(x.reshape(1, B * C, H, W), pad)
        xf = F.conv2d(xf, kern[:, None, None, :], groups=B * C)
        xf = F.conv2d(xf, kern[:, None, :, None], groups=B * C)
        x = xf.reshape(B, C, H, W)

    # ---- corruptions ------------------------------------------------------
    if cfg.noise > 0:
        sig = torch.abs(src.normal(B, 1, 1, 1)) * cfg.noise_std
        sig = gate(cfg.noise, p, sig, torch.zeros_like(sig), torch.full(
            (B, 1, 1, 1), _erfinv(dp) * cfg.noise_std if dp is not None
            else 0.0, device=dev))
        noise = src.normal(B, H, W, C).permute(0, 3, 1, 2)
        x = x + noise * sig
    if cfg.cutout > 0:
        size = torch.full((B, 2), cfg.cutout_size, device=dev)
        size = gate(cfg.cutout, p, size, torch.zeros_like(size), torch.full(
            (B, 2), cfg.cutout_size if dp is not None else 0.0, device=dev))
        center = src.uniform(B, 2)
        if dp is not None:
            center = torch.full((B, 2), dp, device=dev)
        cx = (torch.arange(W, device=dev) + 0.5) / W
        cy = (torch.arange(H, device=dev) + 0.5) / H
        mask_x = torch.abs(cx[None, :] - center[:, 0:1]) >= size[:, 0:1] / 2
        mask_y = torch.abs(cy[None, :] - center[:, 1:2]) >= size[:, 1:2] / 2
        mask = (mask_x[:, None, :] | mask_y[:, :, None]).to(x.dtype)
        x = x * mask[:, None]

    return x.permute(0, 2, 3, 1).to(in_dtype), src.plan


def _execute_geometric(x: torch.Tensor, g_inv: torch.Tensor
                       ) -> torch.Tensor:
    """The anti-aliased affine warp of NCHW ``x``: reflect pad by
    ``dim − 1`` (the bound of the reference's data-dependent margin) →
    sym6 FIR 2x upsample → bilinear warp by ``g_inv`` (centred-pixel
    coordinates) → FIR 2x downsample to the input's size."""
    B, C, H, W = x.shape
    dev = x.device
    f = setup_filter(_SYM6, device=dev)
    hz_pad = f.shape[0] // 4
    x = F.pad(x, (W - 1, W - 1, H - 1, H - 1), mode='reflect')
    x = upsample2d(x, f, up=2)
    in_h, in_w = x.shape[2], x.shape[3]
    out_h, out_w = (H + hz_pad * 2) * 2, (W + hz_pad * 2) * 2

    def c3(v):
        return torch.full((1,), float(v), device=dev)

    # the affine in align_corners=False normalised coordinates
    g = _s2d(c3(2.0), c3(2.0)) @ g_inv @ _s2d(c3(0.5), c3(0.5))
    g = _t2d(c3(-0.5), c3(-0.5)) @ g @ _t2d(c3(0.5), c3(0.5))
    g = (_s2d(c3(2.0 / in_w), c3(2.0 / in_h)) @ g
         @ _s2d(c3(out_w / 2.0), c3(out_h / 2.0)))
    ox = (2.0 * torch.arange(out_w, device=dev, dtype=torch.float32)
          + 1.0) / out_w - 1.0
    oy = (2.0 * torch.arange(out_h, device=dev, dtype=torch.float32)
          + 1.0) / out_h - 1.0
    gy, gx = torch.meshgrid(oy, ox, indexing='ij')
    pts = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones(out_h * out_w, device=dev)], -1)
    coords = torch.einsum('bij,pj->bpi', g[:, :2, :], pts)
    x = F.grid_sample(x, coords.reshape(B, out_h, out_w, 2), mode='bilinear',
                      padding_mode='zeros', align_corners=False)
    # crop the filter's transient; the pre-flip cancels upfirdn2d's flip
    fw = f.shape[1]
    pad0 = (fw - 2 + 1) // 2 - hz_pad * 2
    pad1 = (fw - 2) // 2 - hz_pad * 2
    return upfirdn2d(x, torch.flip(f, (0, 1)), down=2,
                     padding=(pad0, pad1, pad0, pad1))


def update_ada_p(p, real_sign_mean, batch_size: int, *,
                 ada_target: float = 0.6, ada_interval: int = 4,
                 ada_kimg: float = 500.0) -> float:
    """The StyleGAN2-ADA controller: move ``p`` by ±(batch·interval) /
    (kimg·1000) toward the target of E[sign(D(real))], clipped to [0, 1];
    in f32, as JAX computes it."""
    f32 = np.float32
    adjust = (f32(np.sign(float(real_sign_mean) - ada_target))
              * f32(batch_size * ada_interval) / f32(ada_kimg * 1000.0))
    return float(np.clip(f32(float(p)) + adjust, f32(0), f32(1)))
