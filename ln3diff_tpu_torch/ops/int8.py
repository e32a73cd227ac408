"""Opt-in W8A8 int8 serving for the DiT denoisers.

Port of ``ln3diff_tpu/ops/int8.py`` for the DiT: ``quantize_weight`` :44
(symmetric per-output-channel int8 weights, stacked and conv layouts),
``_quantize_rows`` :64 (dynamic per-token activations), ``int8_dense``
:73, ``Int8Dense`` :87 as :class:`Int8Linear` (a drop-in for
``nn.Linear``), ``quantize_params_like`` :224 as a ``state_dict``
transform, and ``quantize_dit`` :170 over a loaded module.  Both operands
are rounded half to even (``torch.round``, as ``jnp.round``), the
int8 × int8 product accumulates exactly in int32, and the result is
rescaled in f32 by ``row_scale · w_scale``, the bias added in f32, then
cast to the input's dtype (the module's compute dtype).

The int32 product is ``torch._int_mm``, the library's int8 GEMM, on the
CPU and on the card: the JAX package computes it with XLA's
``dot_general``, not a Pallas kernel, so it is not a kernel to port.  On
CUDA, ``_int_mm`` takes only more than 16 rows and inner and outer dims
that are multiples of 8, and runs fastest with the weight operand
column-major: rows are zero-padded up to 17 (exact in integer
arithmetic), :class:`Int8Linear` stores ``kernel_q`` as ``(out, in)``
once, so that its transpose is the column-major operand, and any other
shape raises.  There is no float fallback.

The int8 convolution (``Int8Conv``) and ``quantize_unet`` wait for the
U-Net; PyTorch has no public int8 convolution on CUDA.  The trade is an
inference-accuracy one that the reference does not make, so it is opt-in
(``DiTConfig.quantized``, ``quantize_dit``); ``tests/test_torch_int8.py``
holds the bounds that ``tests/test_int8.py`` pins against bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

_MIN_ROWS = 17          # torch._int_mm on CUDA: more than 16 rows


def quantize_weight(w: torch.Tensor, all_but_last: bool = False):
    """Symmetric per-output-channel int8 quantization of ``w`` in the JAX
    layout ``(..., in, out)``: one scale per (stack..., out) channel,
    reduced over the contraction axis ``in`` (ndim − 2) — or, with
    ``all_but_last``, over every leading axis (the conv layout (kh, kw,
    in, out)).  Returns ``(w_q int8, scale f32)``."""
    w = w.float()
    axes = tuple(range(w.ndim - 1)) if all_but_last else (w.ndim - 2,)
    amax = w.abs().amax(dim=axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    kept = [d for i, d in enumerate(w.shape) if i not in axes]
    return w_q, scale.reshape(kept)


def _quantize_rows(x: torch.Tensor):
    """Dynamic symmetric per-token (last-axis row) int8 quantization →
    (x_q int8, scale f32 (..., 1))."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    x_q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return x_q, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 ``a`` (M, K) and ``b`` (K, N) through
    ``torch._int_mm``.  On CUDA, M ≤ 16 is zero-padded to 17 rows; K and N
    must be multiples of 8 (a ``ValueError`` otherwise)."""
    M, K = a.shape
    N = b.shape[1]
    if a.is_cuda:
        if K % 8 or N % 8:
            raise ValueError(f'int8 GEMM on CUDA needs inner and outer dims '
                             f'that are multiples of 8, got K={K}, N={N}')
        if M < _MIN_ROWS:
            pad = a.new_zeros((_MIN_ROWS, K))
            pad[:M] = a
            return torch._int_mm(pad, b)[:M]
    return torch._int_mm(a.contiguous(), b)


def int8_dense(x: torch.Tensor, kernel_q: torch.Tensor,
               w_scale: torch.Tensor, bias=None,
               dtype=None) -> torch.Tensor:
    """``x @ dequant(w)`` with both operands int8.  ``x`` (..., in);
    ``kernel_q`` (out, in) int8, the weight's transpose as
    :func:`quantize_weight` gives it; ``w_scale`` (out,) f32.  Accumulates
    exactly in int32, rescales in f32 by ``row_scale · w_scale``, adds the
    bias in f32 and returns ``dtype`` (default: x's dtype)."""
    dtype = dtype or x.dtype
    x_q, x_scale = _quantize_rows(x)
    lead = x_q.shape[:-1]
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), kernel_q.t())
    y = acc.reshape(*lead, -1).float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


class Int8Linear(nn.Module):
    """Drop-in for ``nn.Linear`` with W8A8 int8 storage and compute.

    Buffers: ``kernel_q`` (out, in) int8, ``scale`` (out,) f32 and
    ``bias`` (out,) f32 or None.  The output takes the input's dtype.
    ``Module.to(dtype)`` leaves the scale and the bias in f32.  Weights
    arrive by :meth:`load_weight`, :func:`quantize_params_like`,
    ``bridge.dit_state_dict`` or ``layers.random_init_``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer('kernel_q', torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer('scale', torch.ones(out_features))
        self.register_buffer('bias', torch.zeros(out_features)
                             if bias else None)

    @torch.no_grad()
    def load_weight(self, weight: torch.Tensor) -> 'Int8Linear':
        """Quantize a float ``(out, in)`` weight into ``kernel_q`` and
        ``scale``."""
        w_q, scale = quantize_weight(weight.t())
        self.kernel_q.copy_(w_q.t())
        self.scale.copy_(scale)
        return self

    def _apply(self, fn, recurse=True):
        f32 = {k: v for k, v in self._buffers.items()
               if v is not None and v.dtype == torch.float32}
        super()._apply(fn, recurse)
        for k, v in f32.items():
            if self._buffers[k].dtype != torch.float32:
                self._buffers[k] = v.to(self._buffers[k].device)
        return self

    def forward(self, x):
        return int8_dense(x, self.kernel_q, self.scale, self.bias)


def quantize_params_like(q_state: dict, state: dict) -> dict:
    """Fill a quantized module's ``state_dict`` (``q_state``: the keys and
    shapes of an :class:`Int8Linear`-bearing module) from the trained
    float ``state`` of its unquantized twin (same module names): wherever
    ``q_state`` holds ``<name>.kernel_q`` and ``<name>.scale``, the twin's
    ``<name>.weight`` is quantized in; every other entry is copied."""
    out = {}
    for key in q_state:
        name, _, leaf = key.rpartition('.')
        if f'{name}.kernel_q' in q_state and leaf in ('kernel_q', 'scale'):
            if leaf == 'kernel_q':
                w_q, scale = quantize_weight(state[f'{name}.weight'].t())
                out[key], out[f'{name}.scale'] = w_q.t().contiguous(), scale
            continue
        if key not in state:
            raise ValueError(f'state dict mismatch: {key} is absent from '
                             f'the source state')
        out[key] = state[key]
    return out


def quantize_dit(module):
    """The W8A8 twin of a loaded ``DiT_TriLatent``: a module of
    ``cfg.quantized=True`` on the same device and in the same dtype, its
    block projections and MLPs quantized from ``module``'s weights
    (``bench.py``'s ``LN3DIFF_BENCH_INT8``); ``module`` is left as it
    is."""
    from ..models.dit import DiT_TriLatent
    p = next(module.parameters())
    with torch.device(p.device):
        q = DiT_TriLatent(dataclasses.replace(module.cfg, quantized=True))
    q.load_state_dict(quantize_params_like(q.state_dict(),
                                           module.state_dict()))
    return q.to(device=p.device, dtype=p.dtype).train(module.training)
