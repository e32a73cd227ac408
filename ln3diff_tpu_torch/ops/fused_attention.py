"""Fused short-sequence self-attention for the DiT sampling path.

Port of ``ln3diff_tpu/ops/fused_attention.py`` (the kernel
``_attn_kernel`` :39 behind ``fused_attention`` :58, and the dispatch
``sdpa_auto`` :87): softmax(q kᵀ/√d) v on ``(B, L, H, d)`` operands with
f32 scores, max, exp and sum, the normalised probabilities rounded to the
input dtype before the product with v, and f32 accumulation of that
product.

``attention_reference`` is the plain PyTorch version of exactly that
arithmetic.  ``fused_attention`` runs it for CPU tensors and launches the
CUDA kernel (``csrc/fused_attention.cu``) for CUDA tensors, or raises when
the kernel does not take them; there is no other branch.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.layers import dot_product_attention
from ._build import LIBRARIES

# what the CUDA kernel takes (csrc/fused_attention.cu)
KERNEL_HEAD_DIMS = (32, 64)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # like the JAX kernel, this one has no backward
        raise RuntimeError('fused_attention has no backward: call it under '
                           'torch.no_grad() or on tensors that need no grad')
    if q.ndim != 4:
        raise ValueError(f'q: shape {tuple(q.shape)}, expected (B, L, H, d)')
    B, L, H, d = q.shape
    for name, t in (('k', k), ('v', v)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                             f'{tuple(q.shape)}')
        if t.dtype != q.dtype:
            raise ValueError(f'{name}: dtype {t.dtype}, expected {q.dtype}')
        if t.device != q.device:
            raise ValueError(f'all inputs must be on {q.device}, got '
                             f'{t.device}')
    if q.device.type != 'cuda':
        raise ValueError(f'fused_attention runs on CPU or CUDA tensors, got '
                         f'{q.device}')
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f'fused_attention: dtype {q.dtype}, the kernel '
                         f'takes {KERNEL_DTYPES}')
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f'fused_attention: head dim {d}, the kernel takes '
                         f'{KERNEL_HEAD_DIMS}')
    if B * H > 65535:
        raise ValueError(f'fused_attention: B*H = {B * H} > 65535')
    itemsize = q.element_size()
    for name, t in (('q', q), ('k', k), ('v', v)):
        if t.stride(3) != 1:
            raise ValueError(f'{name}: needs unit stride along d')
        if (t.data_ptr() % 16
                or any(t.stride(i) * itemsize % 16 for i in range(3))):
            raise ValueError(f'{name}: rows must be 16-byte aligned')

    o = torch.empty((B, L, H, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    fn = LIBRARIES.function('fused_attention', 'ln3diff_fused_attention', [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, L, H, d, strides,
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f'fused_attention kernel launch failed: CUDA '
                           f'error {err}')
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
