"""Fused short-sequence self-attention for the DiT sampling path.

Port of ``ln3diff_tpu/ops/fused_attention.py``:

* the kernel ``_attn_kernel`` :39 behind ``fused_attention`` :58, and the
  dispatch ``sdpa_auto`` :87: softmax(q kᵀ/√d) v on ``(B, L, H, d)``
  operands with f32 scores, max, exp and sum, the normalised probabilities
  rounded to the input dtype before the product with v, and f32
  accumulation of that product;
* the kernel ``_qkv_attn_kernel`` :104 behind ``fused_qkv_attention``
  :145, with its layout helper ``split_qkv_weights`` :182: the qkv
  projection of ``(B, L, D)`` inputs with head-major weights, each of q, k
  and v rounded once to the input dtype after the f32 bias, then the same
  attention, heads concatenated back to ``(B, L, D)``.

``attention_reference`` and ``qkv_attention_reference`` are the plain
PyTorch versions of exactly that arithmetic.  ``fused_attention`` and
``fused_qkv_attention`` run them for CPU tensors and launch their CUDA
kernels (``csrc/fused_attention.cu``, ``csrc/fused_qkv_attention.cu``) for
CUDA tensors, or raise when the kernel does not take them; there is no
other branch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.layers import dot_product_attention
from ._build import LIBRARIES, launch

# what the CUDA kernels take (csrc/fused_attention.cu)
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the bf16 kernels' tiles (csrc/attention_common.cuh, attn::sm90;
# csrc/fused_qkv_attention.cu, proj::sm90)
KEY_TILE = 64         # keys per tile of the K/V ring
PROJ_K_CHUNK = 64     # depth of one projection chunk

_ATTN_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_longlong] * 12
                  + [ctypes.c_float, ctypes.c_void_p])
_QKV_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_void_p])


def _raise_on(err, what):
    if err >= 10000:
        raise RuntimeError(f'{what}: the TMA tensor map could not be '
                           f'encoded (code {err})')
    if err != 0:
        raise RuntimeError(f'{what} kernel launch failed: CUDA error {err}')


def key_tiles(L: int) -> int:
    """Key tiles of ``KEY_TILE`` keys that each pass of the bf16 kernel
    streams through its ring for a sequence of L keys."""
    return -(-L // KEY_TILE)


def key_mask(L: int) -> torch.Tensor:
    """``(key_tiles(L), KEY_TILE)`` bool: True where a tile's key is below L.
    The kernel sets the scores of the other keys to -inf (TMA reads their
    rows of K and V as zeros, which would give s = 0)."""
    keys = torch.arange(key_tiles(L) * KEY_TILE).reshape(-1, KEY_TILE)
    return keys < L


def _byte_strides(t, name: str):
    """(row, head, batch) byte strides of a ``(B, L, H, d)`` view; raises
    ValueError unless d has unit stride, the data is 16-byte aligned and
    every byte stride is a multiple of 16 (TMA's rule)."""
    sb, sl, sh, sd = t.stride()
    if sd != 1:
        raise ValueError(f'{name}: needs unit stride along d')
    es = t.element_size()
    # the item size is a power of two, so the OR has a low bit set iff
    # one of the strides does
    if t.data_ptr() % 16 or (sl | sh | sb) * es % 16:
        raise ValueError(f'{name}: rows must be 16-byte aligned (byte '
                         f'strides {(sl * es, sh * es, sb * es)} must be '
                         f'multiples of 16)')
    return sl * es, sh * es, sb * es


def tma_geometry(t, name: str = 't'):
    """The TMA tensor map of a ``(B, L, H, d)`` view, as the kernel encodes
    it: dims innermost first ``(d, L, H, B)`` and the byte strides of dims
    1..3 ``(row, head, batch)``.  Raises ValueError as
    :func:`fused_attention` does for a view the kernel cannot read."""
    B, L, H, d = t.shape
    return (d, L, H, B), _byte_strides(t, name)


def attention_reference(q, k, v):
    """Plain version: ``(B, L, H, d)`` q, k, v → ``(B, L, H, d)`` in the
    input dtype.

    s = q·kᵀ accumulated in f32 and scaled by 1/√d; f32 max, exp and sum;
    p = e / Σe cast to the input dtype; o = p·v accumulated in f32, cast to
    the input dtype.  bf16 products are exact in f32, so the upcast
    matmuls are the f32 accumulation of the TPU kernel.
    """
    d = q.shape[-1]
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    o = torch.einsum('bhqk,bkhd->bqhd', p.float(), v.float())
    return o.to(q.dtype)


def fused_attention(q, k, v):
    """Same contract as :func:`attention_reference`.

    CPU tensors run the plain version.  Any other tensors are checked and
    then launch the kernel (counted in ``FusedAttention.launches``) or
    raise.  The kernel has no backward (the JAX kernel has no VJP either),
    so with grad mode on, an input that requires grad raises.  q, k and v
    must be CUDA tensors of one shape ``(B, L, H, d)`` and one dtype (bf16
    or f32), with d in {32, 64}, unit stride along d and 16-byte aligned
    rows.  They may be strided views, for example the
    thirds of one qkv projection, and are read in place.
    """
    if q.device.type == 'cpu':
        return attention_reference(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # like the JAX kernel, this one has no backward
        raise RuntimeError('fused_attention has no backward: call it under '
                           'torch.no_grad() or on tensors that need no grad')
    if q.ndim != 4:
        raise ValueError(f'q: shape {tuple(q.shape)}, expected (B, L, H, d)')
    shape, dtype, device = q.shape, q.dtype, q.device
    B, L, H, d = shape
    for name, t in (('k', k), ('v', v)):
        if t.shape != shape:
            raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                             f'{tuple(shape)}')
        if t.dtype != dtype:
            raise ValueError(f'{name}: dtype {t.dtype}, expected {dtype}')
        if t.device != device:
            raise ValueError(f'all inputs must be on {device}, got '
                             f'{t.device}')
    if device.type != 'cuda':
        raise ValueError(f'fused_attention runs on CPU or CUDA tensors, got '
                         f'{device}')
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f'fused_attention: dtype {dtype}, the kernel '
                         f'takes {KERNEL_DTYPES}')
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'fused_attention: head dim {d}, the kernel takes '
                         f'{KERNEL_HEAD_DIMS}')
    if B * H > 65535:
        raise ValueError(f'fused_attention: B*H = {B * H} > 65535')
    sq = _byte_strides(q, 'q')
    sk = _byte_strides(k, 'k')
    sv = _byte_strides(v, 'v')

    o = torch.empty((B, L, H, d), dtype=dtype, device=device)
    if o.numel() == 0:
        return o
    es = o.element_size()
    fn = LIBRARIES.function('fused_attention', 'ln3diff_fused_attention',
                            _ATTN_ARGTYPES)
    # o is contiguous: (row, head, batch) byte strides H·d, d, L·H·d
    err = launch(device, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 o.data_ptr(), int(dtype == torch.bfloat16), B, L, H, d,
                 *sq, *sk, *sv, H * d * es, d * es, L * H * d * es,
                 1.0 / math.sqrt(d))
    _raise_on(err, 'fused_attention')
    FusedAttention.launches += 1
    return o


class FusedAttention:
    """``FusedAttention.launches`` counts launches of the CUDA kernel (not
    calls of the plain version)."""
    launches = 0


def sdpa_auto(q, k, v, use_fused: bool = False):
    """The DiT's self-attention dispatch: :func:`fused_attention` when
    ``use_fused`` (the serving switch ``DiTConfig.fused_attention``), else
    the plain attention of ``jax.nn.dot_product_attention``'s numerics."""
    if use_fused:
        return fused_attention(q, k, v)
    return dot_product_attention(q, k, v)


def split_qkv_weights(kernel, bias, num_heads: int):
    """One qkv projection's ``(D, 3D)`` kernel (JAX's ``nn.Dense`` layout,
    q | k | v along the columns) and ``(3D,)`` bias → head-major
    ``(wq, wk, wv)``, each ``(H, D, d)``, and ``(bq, bk, bv)``, each
    ``(H, d)``, contiguous.  A ``None`` bias gives zeros in the kernel's
    dtype.  For a ``torch.nn.Linear(D, 3D)`` (the port's
    ``Attention.qkv``) pass ``lin.weight.T`` and ``lin.bias``.  A one-time
    layout transform, not a per-step one."""
    D = kernel.shape[0]
    d = D // num_heads
    ws, bs = [], []
    for i in range(3):
        w = kernel[:, i * D:(i + 1) * D].reshape(D, num_heads, d)
        ws.append(w.permute(1, 0, 2).contiguous())
        bs.append(bias[i * D:(i + 1) * D].reshape(num_heads, d).contiguous()
                  if bias is not None else
                  torch.zeros((num_heads, d), dtype=kernel.dtype,
                              device=kernel.device))
    return tuple(ws), tuple(bs)


def qkv_attention_reference(x, wq, wk, wv, bq, bk, bv, num_heads: int):
    """Plain version: x ``(B, L, D)``, head-major weights ``(H, D, d)`` and
    biases ``(H, d)`` → ``(B, L, D)`` in x's dtype, the heads concatenated
    (before the out projection).

    q = (x·wq accumulated in f32 + the bias in f32) rounded to x's dtype,
    and the same for k and v; then :func:`attention_reference`.  This is
    not ``nn.Linear`` in bf16, which would round the product before the
    bias is added.
    """
    B, L, D = x.shape
    if wq.shape[0] != num_heads:
        raise ValueError(f'weights hold {wq.shape[0]} heads, num_heads is '
                         f'{num_heads}')

    def project(w, b):
        y = torch.einsum('bld,hde->blhe', x.float(), w.float()) + b.float()
        return y.to(x.dtype)

    o = attention_reference(project(wq, bq), project(wk, bk),
                            project(wv, bv))
    return o.reshape(B, L, D)


def fused_qkv_attention(x, wq, wk, wv, bq, bk, bv, num_heads: int):
    """Same contract as :func:`qkv_attention_reference`.

    CPU tensors run the plain version.  Any other tensors are checked and
    then launch the kernel (counted in ``FusedQKVAttention.launches``) or
    raise.  The kernel has no backward (the JAX kernel has no VJP either),
    so with grad mode on, an input that requires grad raises.  x must be a
    contiguous ``(B, L, D)`` CUDA tensor, bf16 or f32, with d = D/H in
    {32, 64}; the weights contiguous ``(H, D, d)`` and the biases
    contiguous ``(H, d)`` (:func:`split_qkv_weights`), all of x's dtype
    and device.
    """
    args = (x, wq, wk, wv, bq, bk, bv)
    if x.device.type == 'cpu':
        return qkv_attention_reference(*args, num_heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError('fused_qkv_attention has no backward: call it '
                           'under torch.no_grad() or on tensors that need '
                           'no grad')
    if x.ndim != 3:
        raise ValueError(f'x: shape {tuple(x.shape)}, expected (B, L, D)')
    B, L, D = x.shape
    H = num_heads
    if D % H:
        raise ValueError(f'D = {D} is not a multiple of num_heads = {H}')
    d = D // H
    shapes = {'wq': (H, D, d), 'wk': (H, D, d), 'wv': (H, D, d),
              'bq': (H, d), 'bk': (H, d), 'bv': (H, d)}
    for (name, want), t in zip(shapes.items(), args[1:]):
        if tuple(t.shape) != want:
            raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                             f'{want}')
    for name, t in zip(('x', *shapes), args):
        if t.dtype != x.dtype:
            raise ValueError(f'{name}: dtype {t.dtype}, expected {x.dtype}')
        if t.device != x.device:
            raise ValueError(f'all inputs must be on {x.device}, got '
                             f'{t.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: must be contiguous (head-major '
                             f'weights from split_qkv_weights)')
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f'fused_qkv_attention: dtype {x.dtype}, the kernel '
                         f'takes {KERNEL_DTYPES}')
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'fused_qkv_attention: head dim {d}, the kernel '
                         f'takes {KERNEL_HEAD_DIMS}')
    if x.device.type != 'cuda':
        raise ValueError(f'fused_qkv_attention runs on CPU or CUDA tensors, '
                         f'got {x.device}')
    if B * H > 65535:
        raise ValueError(f'fused_qkv_attention: B*H = {B * H} > 65535')
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError('fused_qkv_attention: inputs must be 16-byte '
                         'aligned')

    o = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    if o.numel() == 0:
        return o
    # the rounded q | k | v of every head, read in place by the attention
    qkv = torch.empty((B, L, 3, H, d), dtype=x.dtype, device=x.device)
    fn = LIBRARIES.function('fused_qkv_attention',
                            'ln3diff_fused_qkv_attention', _QKV_ARGTYPES)
    err = launch(x.device, fn, *(t.data_ptr() for t in args),
                 qkv.data_ptr(), o.data_ptr(),
                 int(x.dtype == torch.bfloat16), B, L, H, d,
                 1.0 / math.sqrt(d))
    _raise_on(err, 'fused_qkv_attention')
    FusedQKVAttention.launches += 1
    return o


class FusedQKVAttention:
    """``FusedQKVAttention.launches`` counts launches of the CUDA kernel
    (not calls of the plain version); kernel 4 does not move
    ``FusedAttention.launches``."""
    launches = 0
