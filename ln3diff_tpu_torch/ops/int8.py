"""Opt-in W8A8 int8 serving for the denoisers (the DiT and the U-Net).

Port of ``ln3diff_tpu/ops/int8.py``: ``quantize_weight`` :44
(symmetric per-output-channel int8 weights, stacked and conv layouts),
``_quantize_rows`` :64 (dynamic per-token activations), ``int8_dense``
:73, ``Int8Dense`` :87 as :class:`Int8Linear` (a drop-in for
``nn.Linear``), ``Int8Conv`` :115 (a drop-in for ``nn.Conv2d``: one
activation scale per batch item), ``quantize_params_like`` :200 as a
``state_dict`` transform, and ``quantize_dit`` :163 / ``quantize_unet``
:191 over a loaded module.  Both operands are rounded half to even
(``torch.round``, as ``jnp.round``), the int8 × int8 product accumulates
exactly in int32, and the result is rescaled in f32 by ``x_scale ·
w_scale`` (the product of the scales taken first), the bias added in f32,
then cast to the input's dtype (the module's compute dtype).

The int32 product is ``torch._int_mm``, the library's int8 GEMM, on the
CPU and on the card: the JAX package computes it with XLA's
``dot_general``, not a Pallas kernel, so it is not a kernel to port.  On
CUDA, ``_int_mm`` takes only more than 16 rows and inner and outer dims
that are multiples of 8, and runs fastest with the weight operand
column-major: rows are zero-padded up to 17 (exact in integer
arithmetic), :class:`Int8Linear` stores ``kernel_q`` as ``(out, in)``
once, so that its transpose is the column-major operand, and any other
shape raises.  There is no float fallback.

PyTorch has no public int8 convolution on CUDA, and JAX computes its own
with XLA's ``conv_general_dilated``, so :class:`Int8Conv` is an im2col
over the same ``int8_matmul``: the int8 activations are padded with
exact zeros and unfolded from their channels-last memory into (C, kh,
kw)-ordered patches, which the weight's (out, in, kh, kw) layout matches.
The trade is an inference-accuracy one that the reference does not make,
so it is opt-in (``DiTConfig.quantized`` / ``UNetConfig.quantized``,
``quantize_dit`` / ``quantize_unet``); ``tests/test_torch_int8.py`` and
``tests/test_torch_int8_unet.py`` hold the bounds that
``tests/test_int8.py`` pins against bf16.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

_MIN_ROWS = 17          # torch._int_mm on CUDA: more than 16 rows


def _amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 by true division on every device: CUDA turns
    a division by a Python scalar into a product with its reciprocal,
    which is an ulp off the quotient now and then (as XLA's rewrite under
    jit is); the divisor is therefore a tensor on amax's device."""
    return torch.clamp(amax, min=1e-12) / amax.new_full((), 127.0)


def _quantize(x: torch.Tensor, dims, amax_reduce=None):
    """Symmetric int8 quantization with one scale per slice over ``dims``
    (the amax over them) → (x_q int8, scale f32 with ``dims`` kept).
    ``amax_reduce``: a function applied to the local amax before the
    scale is taken — the MAX all-reduce over the tensor ranks when ``x``
    is a rank's slice of the quantized axis, so that every rank takes the
    one-rank scale."""
    x = x.float()
    amax = x.abs().amax(dim=dims, keepdim=True)
    if amax_reduce is not None:
        amax = amax_reduce(amax)
    scale = _amax_scale(amax)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale


def quantize_weight(w: torch.Tensor, all_but_last: bool = False):
    """Symmetric per-output-channel int8 quantization of ``w`` in the JAX
    layout ``(..., in, out)``: one scale per (stack..., out) channel,
    reduced over the contraction axis ``in`` (ndim − 2) — or, with
    ``all_but_last``, over every leading axis (the conv layout (kh, kw,
    in, out)).  Returns ``(w_q int8, scale f32)``."""
    axes = tuple(range(w.ndim - 1)) if all_but_last else (w.ndim - 2,)
    w_q, scale = _quantize(w, axes)
    kept = [d for i, d in enumerate(w.shape) if i not in axes]
    return w_q, scale.reshape(kept)


def _quantize_rows(x: torch.Tensor, amax_reduce=None):
    """Dynamic symmetric per-token (last-axis row) int8 quantization →
    (x_q int8, scale f32 (..., 1)); ``amax_reduce`` as :func:`_quantize`."""
    return _quantize(x, -1, amax_reduce)


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
    x_q, x_scale = _quantize_rows(x)
    return int8_rescale(int8_dense_acc(x_q, kernel_q), x_scale, w_scale,
                        bias, dtype or x.dtype)


def int8_dense_acc(x_q: torch.Tensor, kernel_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 accumulator (..., out) of int8 ``x_q`` (..., in)
    and ``kernel_q`` (out, in)."""
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), kernel_q.t())
    return acc.reshape(*x_q.shape[:-1], -1)


def int8_rescale(acc: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor, bias, dtype) -> torch.Tensor:
    """``acc`` (int32) in f32 × ``x_scale · w_scale`` (the product of the
    scales taken first), plus the bias in f32, cast to ``dtype``."""
    y = acc.float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def _quantize_weight_torch_layout(weight: torch.Tensor):
    """Quantize a float weight in PyTorch's layout — Linear ``(out, in)``
    or Conv2d ``(out, in, kh, kw)`` — as JAX quantizes its ``(in, out)`` or
    ``(kh, kw, in, out)`` kernel; returns ``(kernel_q, scale)`` in the
    PyTorch layout."""
    if weight.ndim == 4:
        w_q, scale = quantize_weight(weight.permute(2, 3, 1, 0),
                                     all_but_last=True)
        return w_q.permute(3, 2, 0, 1).contiguous(), scale
    w_q, scale = quantize_weight(weight.t())
    return w_q.t().contiguous(), scale


class Int8Module(nn.Module):
    """Buffers ``kernel_q`` (int8, PyTorch's weight layout), ``scale``
    (out,) f32 and ``bias`` (out,) f32 or None.  ``Module.to(dtype)``
    leaves the scale and the bias in f32."""

    def __init__(self, shape, bias: bool):
        super().__init__()
        self.register_buffer('kernel_q', torch.zeros(shape,
                                                     dtype=torch.int8))
        self.register_buffer('scale', torch.ones(shape[0]))
        self.register_buffer('bias', torch.zeros(shape[0]) if bias
                             else None)

    @torch.no_grad()
    def load_weight(self, weight: torch.Tensor):
        """Quantize a float weight of the float layer's shape into
        ``kernel_q`` and ``scale``."""
        w_q, scale = _quantize_weight_torch_layout(weight)
        self.kernel_q.copy_(w_q)
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


class Int8Linear(Int8Module):
    """Drop-in for ``nn.Linear`` with W8A8 int8 storage and compute:
    ``kernel_q`` (out, in).  The output takes the input's dtype.  Weights
    arrive by :meth:`load_weight`, :func:`quantize_params_like`, the
    bridge or ``layers.random_init_``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__((out_features, in_features), bias)
        self.in_features, self.out_features = in_features, out_features

    def forward(self, x):
        return int8_dense(x, self.kernel_q, self.scale, self.bias)


def quantize_per_sample(x: torch.Tensor, amax_reduce=None):
    """Dynamic symmetric int8 quantization with one scale per batch item
    (the amax over every other axis) → (x_q int8, scale f32 (B, 1, …));
    ``amax_reduce`` as :func:`_quantize`."""
    return _quantize(x, tuple(range(1, x.ndim)), amax_reduce)


def im2col(x_q: torch.Tensor, kernel: int, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """(C, kh, kw)-ordered patches of channels-last ``x_q`` (B, H, W, C),
    zero-padded: (B, Ho, Wo, C·kernel²), unfolded from the NHWC memory
    (``F.unfold`` takes no int8)."""
    if padding:
        x_q = F.pad(x_q, (0, 0, padding, padding, padding, padding))
    patches = x_q.unfold(1, kernel, stride).unfold(2, kernel, stride)
    return patches.reshape(*patches.shape[:3], -1)


def int8_conv_acc(x_q: torch.Tensor, kernel_q: torch.Tensor,
                  stride: int = 1, padding: int = 0) -> torch.Tensor:
    """Exact int32 convolution of channels-last int8 activations ``x_q``
    (B, H, W, C) with an int8 ``kernel_q`` (out, C, k, k): :func:`im2col`
    and one :func:`int8_matmul`.  Returns (B, Ho, Wo, out) int32."""
    N, _, k, _ = kernel_q.shape
    patches = im2col(x_q, k, stride, padding)
    acc = int8_matmul(patches.reshape(-1, patches.shape[-1]),
                      kernel_q.reshape(N, -1).t())
    return acc.reshape(*patches.shape[:3], N)


class Int8Conv(Int8Module):
    """Drop-in for ``nn.Conv2d`` (square kernel, symmetric zero padding)
    with W8A8 int8 compute: ``kernel_q`` (out, in, kh, kw) with one scale
    per output channel (reduced over kh·kw·in), and one activation scale
    per batch item (the amax over C, H and W; zero padding quantizes to
    exact 0).  Takes and returns NCHW-shaped tensors; the output is in
    channels-last memory and the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 bias: bool = True):
        super().__init__((out_channels, in_channels, kernel_size,
                          kernel_size), bias)
        self.in_channels, self.out_channels = in_channels, out_channels
        self.stride, self.padding = stride, padding

    def forward(self, x):
        return int8_conv(x, self.kernel_q, self.scale, self.bias,
                         self.stride, self.padding)


def int8_conv(x: torch.Tensor, kernel_q: torch.Tensor,
              w_scale: torch.Tensor, bias=None, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """:class:`Int8Conv`'s function: NCHW-shaped ``x`` quantized per
    sample, the exact int32 convolution with ``kernel_q`` (out, in, k, k),
    rescaled in f32 — NCHW-shaped output in channels-last memory, in x's
    dtype."""
    x_q, x_scale = quantize_per_sample(x.permute(0, 2, 3, 1))
    acc = int8_conv_acc(x_q, kernel_q, stride, padding)
    return int8_rescale(acc, x_scale, w_scale, bias,
                        x.dtype).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# tensor-parallel shards: the rank-local pieces (no process group)
# ---------------------------------------------------------------------------
# A column shard holds the rank's output rows of ``kernel_q`` with their
# ``scale`` and ``bias``; it quantizes the whole input exactly as the
# whole layer does, so its output is the matching slice of the whole
# layer's, bit for bit.  A row shard holds the rank's input columns of
# ``kernel_q`` (dim 1 of the Linear and the conv layout alike) and gives
# a partial int32 accumulator; the partials summed over the ranks in
# int32 are the whole layer's accumulator exactly (integer sums do not
# round), and only then is the sum rescaled by ``x_scale · w_scale`` and
# the bias added, once.  The activation scale of a row shard is the whole
# layer's: a whole input is quantized whole and the rank takes its
# columns; an input that is already the rank's slice (after a column
# layer) has its per-token (per-sample, for a conv) amax MAX-reduced over
# the ranks before the scale is taken.  This is the computation GSPMD
# makes of JAX's int32 ``dot_general`` with a sharded contraction axis.

def check_int8_shard(name: str, in_width: int, out_width: int,
                     device) -> None:
    """Refuse an int8 shard that :func:`int8_matmul` cannot run: on CUDA
    the GEMM's inner width (``in_width``; a conv's in-channels × k²) and
    outer width (``out_width``) must be multiples of 8.  Raises a
    ``ValueError`` naming the layer ``name``."""
    if torch.device(device).type == 'cuda' and (in_width % 8
                                                or out_width % 8):
        raise ValueError(
            f'{name}: an int8 shard of inner width {in_width} and outer '
            f'width {out_width}; the int8 GEMM on CUDA needs multiples of 8')


def column_shard(module: Int8Module, rows: torch.Tensor):
    """``(kernel_q, scale, bias)`` of the output rows (channels) ``rows``
    of an :class:`Int8Linear` or :class:`Int8Conv`."""
    return (module.kernel_q[rows], module.scale[rows],
            None if module.bias is None else module.bias[rows])


def row_shard(module: Int8Module, cols: torch.Tensor) -> torch.Tensor:
    """The input columns (channels) ``cols`` of ``module.kernel_q``."""
    return module.kernel_q[:, cols]


def int8_dense_row_partial(x: torch.Tensor, kernel_q_cols: torch.Tensor,
                           cols=None, amax_reduce=None):
    """A row shard's ``(int32 partial (..., out), x_scale (..., 1))``: with
    ``cols``, ``x`` is the whole input, quantized per token and then cut to
    the rank's columns; without, ``x`` is the rank's columns and its
    per-token amax goes through ``amax_reduce`` (the MAX all-reduce)."""
    if cols is not None:
        x_q, x_scale = _quantize_rows(x)
        x_q = x_q.index_select(-1, cols)
    else:
        x_q, x_scale = _quantize_rows(x, amax_reduce)
    return int8_dense_acc(x_q, kernel_q_cols), x_scale


def int8_conv_row_partial(x: torch.Tensor, kernel_q_cols: torch.Tensor,
                          stride: int = 1, padding: int = 0, cols=None,
                          amax_reduce=None):
    """:func:`int8_dense_row_partial` for an :class:`Int8Conv` shard over
    input channels: NCHW-shaped ``x`` (whole with ``cols``, else the
    rank's channels) → ``(int32 partial (B, Ho, Wo, out), x_scale (B, 1,
    1, 1))``, the scale one per sample."""
    x = x.permute(0, 2, 3, 1)
    if cols is not None:
        x_q, x_scale = quantize_per_sample(x)
        x_q = x_q.index_select(-1, cols)
    else:
        x_q, x_scale = quantize_per_sample(x, amax_reduce)
    return int8_conv_acc(x_q, kernel_q_cols, stride, padding), x_scale


def quantize_params_like(q_state: dict, state: dict) -> dict:
    """Fill a quantized module's ``state_dict`` (``q_state``: the keys and
    shapes of an :class:`Int8Linear` / :class:`Int8Conv`-bearing module)
    from the trained float ``state`` of its unquantized twin (same module
    names): wherever ``q_state`` holds ``<name>.kernel_q`` and
    ``<name>.scale``, the twin's ``<name>.weight`` is quantized in — a
    conv weight ``(out, in, kh, kw)`` as JAX's ``(kh, kw, in, out)`` with
    one scale per output channel; every other entry is copied."""
    out = {}
    for key in q_state:
        name, _, leaf = key.rpartition('.')
        if f'{name}.kernel_q' in q_state and leaf in ('kernel_q', 'scale'):
            if leaf == 'kernel_q':
                out[key], out[f'{name}.scale'] = \
                    _quantize_weight_torch_layout(state[f'{name}.weight'])
            continue
        if key not in state:
            raise ValueError(f'state dict mismatch: {key} is absent from '
                             f'the source state')
        out[key] = state[key]
    return out


def _quantize_model(model_cls, module):
    p = next(module.parameters())
    with torch.device(p.device):
        q = model_cls(dataclasses.replace(module.cfg, quantized=True))
    q.load_state_dict(quantize_params_like(q.state_dict(),
                                           module.state_dict()))
    return q.to(device=p.device, dtype=p.dtype).train(module.training)


def quantize_dit(module):
    """The W8A8 twin of a loaded ``DiT_TriLatent``: a module of
    ``cfg.quantized=True`` on the same device and in the same dtype, its
    block projections and MLPs quantized from ``module``'s weights
    (``bench.py``'s ``LN3DIFF_BENCH_INT8``); ``module`` is left as it
    is."""
    from ..models.dit import DiT_TriLatent
    return _quantize_model(DiT_TriLatent, module)


def quantize_unet(module):
    """The W8A8 twin of a loaded ``UNetModel`` (the ShapeNet/FFHQ path):
    the ResBlock convs, the resampling convs, the attention projections
    and the transformer layers go int8; ``conv_in``, ``conv_out``, the
    time MLP, the ResBlocks' embedding projections and ``mixing_logit``
    are copied as they are.  ``module`` is left as it is."""
    from ..models.unet import UNetModel
    return _quantize_model(UNetModel, module)
