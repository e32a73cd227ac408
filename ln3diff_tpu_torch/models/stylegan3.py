"""StyleGAN3 alias-free generator (reference ``nsr/networks_stylegan3.py``).

Port of ``ln3diff_tpu/models/stylegan3.py``: ``design_lowpass_filter``
:34 (scipy, as the JAX module computes it), ``_as_2d`` :63,
``filtered_lrelu`` :69 (bias → zero-stuff → pad on the upsampled grid →
FIR → leaky ReLU × gain → clamp → FIR → keep every ``down``-th, the
plain chain of the reference's ``_filtered_lrelu_ref``), the SG3
``modulated_conv2d_sg3`` :94, ``SynthesisInput`` :134 (random Fourier
features; the frequencies, phases and the user transform are buffers, the
JAX module's ``'stats'`` collection), ``SynthesisLayerSG3`` :213 (its
``magnitude_ema`` a buffer too), ``SynthesisNetworkSG3`` :295 and
``GeneratorSG3`` :368.

The filter design, the cutoffs, sampling rates and paddings are numpy,
computed once when a layer is built; the filters are buffers on the
module's device.  ``SynthesisInput`` returns channels-last features and
``SynthesisNetworkSG3`` / ``GeneratorSG3`` a channels-last image, as the
JAX modules do; the layers in between take and return NCHW.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import EqualDense
from .stylegan import MappingNetwork, upfirdn2d


def design_lowpass_filter(numtaps: int, cutoff: float, width: float,
                          fs: float, radial: bool = False
                          ) -> Optional[np.ndarray]:
    """Kaiser-windowed low-pass FIR (reference
    ``networks_stylegan3.py:474-499``): 1-D taps of a separable filter, a
    2-D jinc kernel when ``radial``, None for the identity."""
    if numtaps < 1:
        raise ValueError(f'numtaps={numtaps}')
    if numtaps == 1:
        return None
    import scipy.signal
    if not radial:
        return scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff,
                                   width=width, fs=fs).astype(np.float32)
    import scipy.special
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide='ignore', invalid='ignore'):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[r == 0] = cutoff  # lim_{r->0} j1(2πc·r)/(π·r) = c
    beta = scipy.signal.kaiser_beta(
        scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f = f * np.outer(w, w)
    f = f / f.sum()
    return f.astype(np.float32)


def _as_2d(f: Optional[np.ndarray]) -> np.ndarray:
    if f is None:
        return np.ones((1, 1), np.float32)
    f = np.asarray(f, np.float32)
    return np.outer(f, f) if f.ndim == 1 else f


def filtered_lrelu(x: torch.Tensor, fu: torch.Tensor, fd: torch.Tensor,
                   bias: Optional[torch.Tensor], up: int, down: int,
                   padding: Tuple[int, int, int, int], gain: float,
                   slope: float, clamp: Optional[float]) -> torch.Tensor:
    """bias (per channel of NCHW ``x``) → zero-stuff by ``up`` → pad by
    ``(px0, px1, py0, py1)`` on the upsampled grid (negative crops) → FIR
    ``fu`` with gain up² → leaky ReLU(``slope``) × ``gain`` → clamp → FIR
    ``fd`` → keep every ``down``-th pixel.  ``fu``/``fd``: 2-D filters
    (``_as_2d``)."""
    if bias is not None:
        x = x + bias.to(x.dtype)[:, None, None]
    x = upfirdn2d(x, fu, up=up, padding=padding)
    x = F.leaky_relu(x, slope) * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return upfirdn2d(x, fd, down=down)


def modulated_conv2d_sg3(x: torch.Tensor, weight: torch.Tensor,
                         styles: torch.Tensor, demodulate: bool = True,
                         padding: int = 0,
                         input_gain: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """SG3 modulated conv (reference ``networks_stylegan3.py:28-72``):
    with ``demodulate`` the weight (per output channel) and the styles
    (over the whole batch) are first normalised to unit second moment,
    then the modulated weight is demodulated per output channel; an
    ``input_gain`` scales it.  x: (B, Cin, H, W); weight: (Cout, Cin, k,
    k); styles: (B, Cin); ``padding`` on every side."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    if demodulate:
        weight = weight * torch.rsqrt(
            weight.square().mean(dim=(1, 2, 3), keepdim=True))
        styles = styles * torch.rsqrt(styles.square().mean())
    w = weight[None] * styles[:, None, :, None, None]       # B Co Ci kh kw
    if demodulate:
        d = torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)
        w = w * d[:, :, None, None, None]
    if input_gain is not None:
        w = w * input_gain
    out = F.conv2d(x.reshape(1, B * Cin, H, W),
                   w.reshape(B * Cout, Cin, kh, kw).to(x.dtype),
                   padding=padding, groups=B)
    return out.reshape(B, Cout, out.shape[2], out.shape[3])


class SynthesisInput(nn.Module):
    """Fourier-feature input (reference ``networks_stylegan3.py:201-293``):
    in-band random frequencies (``freqs``, numpy ``RandomState(0)``) and
    phases (``RandomState(1)``), rotated and translated per sample by an
    affine map of w (identity at init), faded out toward the Nyquist rate,
    and mixed by a trained ``weight``.  ``transform`` is the user's inverse
    output transform (identity).  w ``(B, w_dim)`` → ``(B, size, size,
    channels)``."""

    def __init__(self, w_dim: int, channels: int, size: int,
                 sampling_rate: float, bandwidth: float):
        super().__init__()
        self.w_dim, self.channels, self.size = w_dim, channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        rng = np.random.RandomState(0)
        f = rng.randn(channels, 2).astype(np.float32)
        radii = np.sqrt((f ** 2).sum(1, keepdims=True))
        f = f / (radii * np.exp(radii ** 2) ** 0.25)
        self.register_buffer('freqs', torch.tensor(f * bandwidth))
        self.register_buffer('phases', torch.tensor(
            np.random.RandomState(1).rand(channels).astype(np.float32)
            - 0.5))
        self.register_buffer('transform', torch.eye(3))
        self.weight = nn.Parameter(torch.randn(channels, channels))
        self.affine_kernel = nn.Parameter(torch.zeros(w_dim, 4))
        self.affine_bias = nn.Parameter(torch.tensor([1., 0., 0., 0.]))
        g = (np.arange(size, dtype=np.float32) + 0.5 - size / 2) \
            / sampling_rate
        self.register_buffer('grid', torch.tensor(g), persistent=False)

    def reset_free_parameters(self, generator=None):
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=self.weight.device))
        self.affine_kernel.zero_()
        self.affine_bias.copy_(torch.tensor([1., 0., 0., 0.]))

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        B = w.shape[0]
        t = w.float() @ (self.affine_kernel / math.sqrt(self.w_dim)) \
            + self.affine_bias
        t = t / torch.linalg.vector_norm(t[:, :2], dim=1, keepdim=True)
        rc, rs, tx, ty = t.unbind(1)
        zeros, ones = torch.zeros_like(rc), torch.ones_like(rc)
        m_r = torch.stack([rc, -rs, zeros, rs, rc, zeros,
                           zeros, zeros, ones], -1).reshape(B, 3, 3)
        m_t = torch.stack([ones, zeros, -tx, zeros, ones, -ty,
                           zeros, zeros, ones], -1).reshape(B, 3, 3)
        transforms = m_r @ m_t @ self.transform[None]
        f = self.freqs[None] @ transforms[:, :2, :2]           # (B, C, 2)
        ph = self.phases[None] + (self.freqs[None]
                                  @ transforms[:, :2, 2:])[..., 0]
        amp = torch.clamp(
            1 - (torch.linalg.vector_norm(f, dim=2) - self.bandwidth)
            / (self.sampling_rate / 2 - self.bandwidth), 0, 1)
        gx = self.grid[None, None, :, None]
        gy = self.grid[None, :, None, None]
        arg = (gx * f[:, None, None, :, 0] + gy * f[:, None, None, :, 1]
               + ph[:, None, None, :])                        # (B, S, S, C)
        x = torch.sin(arg * (2 * np.pi)) * amp[:, None, None, :]
        return x @ (self.weight.t() / math.sqrt(self.channels))


class SynthesisLayerSG3(nn.Module):
    """One alias-free layer (reference ``networks_stylegan3.py:306-472``):
    the style affine of w, the modulated 3x3 conv (1x1 without
    demodulation for the ToRGB layer) at the input rate with the input
    gain rsqrt(``magnitude_ema``), then ``filtered_lrelu`` from the input
    to the output rate with the layer's Kaiser filters.  NCHW."""

    def __init__(self, w_dim: int, is_torgb: bool,
                 is_critically_sampled: bool, in_channels: int,
                 out_channels: int, in_size: int, out_size: int,
                 in_sampling_rate: float, out_sampling_rate: float,
                 in_cutoff: float, out_cutoff: float, in_half_width: float,
                 out_half_width: float, conv_kernel: int = 3,
                 filter_size: int = 6, lrelu_upsampling: int = 2,
                 use_radial_filters: bool = False,
                 conv_clamp: Optional[float] = 256.0,
                 magnitude_ema_beta: float = 0.999):
        super().__init__()
        self.is_torgb = is_torgb
        self.conv_clamp = conv_clamp
        self.magnitude_ema_beta = magnitude_ema_beta
        k = self.k = 1 if is_torgb else conv_kernel
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (
            1 if is_torgb else lrelu_upsampling)
        self.up = int(round(tmp_rate / in_sampling_rate))
        up_taps = (filter_size * self.up
                   if self.up > 1 and not is_torgb else 1)
        fu = design_lowpass_filter(up_taps, in_cutoff, in_half_width * 2,
                                   tmp_rate)
        self.down = int(round(tmp_rate / out_sampling_rate))
        down_taps = (filter_size * self.down
                     if self.down > 1 and not is_torgb else 1)
        fd = design_lowpass_filter(
            down_taps, out_cutoff, out_half_width * 2, tmp_rate,
            radial=use_radial_filters and not is_critically_sampled)
        # the symmetric-interpretation padding (paper, appendix C.3)
        pad_total = ((out_size - 1) * self.down + 1
                     - (in_size + k - 1) * self.up
                     + up_taps + down_taps - 2)
        pad_lo = (pad_total + self.up) // 2
        pad_hi = pad_total - pad_lo
        self.padding = (pad_lo, pad_hi, pad_lo, pad_hi)
        self.register_buffer('fu', torch.tensor(_as_2d(fu)),
                             persistent=False)
        self.register_buffer('fd', torch.tensor(_as_2d(fd)),
                             persistent=False)
        self.register_buffer('magnitude_ema', torch.ones(()))
        self.affine = EqualDense(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.randn(out_channels, in_channels,
                                               k, k))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def reset_free_parameters(self, generator=None):
        self.weight.copy_(torch.randn(self.weight.shape, generator=generator,
                                      device=self.weight.device))

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                update_emas: bool = False) -> torch.Tensor:
        if update_emas:
            with torch.no_grad():
                cur = x.detach().float().square().mean()
                self.magnitude_ema.copy_(cur + self.magnitude_ema_beta
                                         * (self.magnitude_ema - cur))
        input_gain = torch.rsqrt(self.magnitude_ema)
        styles = self.affine(w.float())
        if self.is_torgb:
            styles = styles / math.sqrt(x.shape[1] * self.k * self.k)
        y = modulated_conv2d_sg3(x.float(), self.weight.float(), styles,
                                 demodulate=not self.is_torgb,
                                 padding=self.k - 1, input_gain=input_gain)
        return filtered_lrelu(
            y, self.fu, self.fd, self.bias, self.up, self.down, self.padding,
            gain=1.0 if self.is_torgb else math.sqrt(2.0),
            slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)


class SynthesisNetworkSG3(nn.Module):
    """The alias-free synthesis stack (reference
    ``networks_stylegan3.py:517-628``): geometric cutoff and stopband
    progressions over ``num_layers`` layers, the last ``num_critical``
    critically sampled, margin-padded intermediate planes, the Fourier
    input and a final ToRGB.  ws ``(B, num_ws, w_dim)`` → ``(B, H, W,
    img_channels)`` f32.  Layer names are the JAX module's
    (``L{i}_{size}_{channels}``)."""

    def __init__(self, w_dim: int = 512, img_resolution: int = 256,
                 img_channels: int = 3, channel_base: int = 32768,
                 channel_max: int = 512, num_layers: int = 14,
                 num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1,
                 last_stopband_rel: float = 2 ** 0.3, margin_size: int = 10,
                 output_scale: float = 0.25, conv_kernel: int = 3,
                 use_radial_filters: bool = False):
        super().__init__()
        self.num_layers, self.output_scale = num_layers, output_scale
        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(
            np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (
            last_stopband / first_stopband) ** exponents
        rates = np.exp2(np.ceil(np.log2(
            np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, rates / 2) - cutoffs
        sizes = (rates + margin_size * 2).astype(np.int64)
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum(
            (channel_base / 2) / cutoffs, channel_max)).astype(np.int64)
        channels[-1] = img_channels

        self.input = SynthesisInput(w_dim, int(channels[0]), int(sizes[0]),
                                    float(rates[0]), float(cutoffs[0]))
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            name = f'L{idx}_{int(sizes[idx])}_{int(channels[idx])}'
            self.add_module(name, SynthesisLayerSG3(
                w_dim=w_dim, is_torgb=idx == num_layers,
                is_critically_sampled=idx >= num_layers - num_critical,
                in_channels=int(channels[prev]),
                out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=float(rates[prev]),
                out_sampling_rate=float(rates[idx]),
                in_cutoff=float(cutoffs[prev]),
                out_cutoff=float(cutoffs[idx]),
                in_half_width=float(half_widths[prev]),
                out_half_width=float(half_widths[idx]),
                conv_kernel=conv_kernel,
                use_radial_filters=use_radial_filters))
            self.layer_names.append(name)

    @property
    def num_ws(self) -> int:
        return self.num_layers + 2

    def forward(self, ws: torch.Tensor,
                update_emas: bool = False) -> torch.Tensor:
        if ws.shape[1] != self.num_ws:
            raise ValueError(f'{ws.shape[1]} ws for {self.num_ws} layers')
        x = self.input(ws[:, 0]).permute(0, 3, 1, 2)
        for idx, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, idx + 1],
                                    update_emas=update_emas)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float().permute(0, 2, 3, 1)


class GeneratorSG3(nn.Module):
    """z (and a label c) → mapping → alias-free synthesis (reference
    ``networks_stylegan3.py:635-678``): ``(B, img_resolution,
    img_resolution, img_channels)``."""

    def __init__(self, z_dim: int = 512, c_dim: int = 0, w_dim: int = 512,
                 img_resolution: int = 256, img_channels: int = 3,
                 num_layers: int = 14, channel_base: int = 32768,
                 channel_max: int = 512, conv_kernel: int = 3,
                 use_radial_filters: bool = False):
        super().__init__()
        self.synthesis = SynthesisNetworkSG3(
            w_dim=w_dim, img_resolution=img_resolution,
            img_channels=img_channels, num_layers=num_layers,
            channel_base=channel_base, channel_max=channel_max,
            conv_kernel=conv_kernel, use_radial_filters=use_radial_filters)
        self.mapping = MappingNetwork(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                                      num_ws=self.synthesis.num_ws)

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor] = None,
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                update_emas: bool = False) -> torch.Tensor:
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff,
                          update_emas=update_emas)
        return self.synthesis(ws, update_emas=update_emas)
