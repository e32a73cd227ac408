"""Fused triplane point pipeline: bilinear lerp → plane mean → OSG MLP.

Port of ``ln3diff_tpu/ops/fused_render.py`` (the forward kernel
``_kernel`` / ``_osg_forward``, ``:98,143``, reached through
``osg_pointwise_fused`` ``:446`` and ``FusedOSG.__call__`` ``:476``).

The corner rows are gathered by torch indexing
(:func:`~ln3diff_tpu_torch.render.renderer.packed_gather`); this module
turns the gathered rows into (rgb, σ) in one pass that writes only the
outputs.  ``osg_pointwise_reference`` is the plain PyTorch version and
repeats the kernel's arithmetic: with bf16 rows the lerp runs in bf16,
the plane mean and both layers in f32 (``fused_render.py:102-108``).
``osg_pointwise_fused`` launches the CUDA kernel
(``csrc/fused_osg.cu``) for CUDA tensors and uses the plain version for
CPU tensors; a CUDA tensor that the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

_ACTIVATIONS = {'sigmoid': 0, 'lrelu': 1}
# the shapes the CUDA kernel is compiled for (csrc/fused_osg.cu)
KERNEL_C, KERNEL_HIDDEN, KERNEL_OUT = 32, 64, 33


def osg_pointwise_reference(rows, tx, ty, live, w1, b1, w2, b2,
                            activation: str = 'sigmoid', inbox=None):
    """Plain version of the fused pipeline.

    Args:
      rows: (3, M, 4C) gathered corner rows [c00 | c01 | c10 | c11].
      tx, ty, live: (3, M) bilinear fractions and validity.
      w1 (C, H), b1 (H,), w2 (H, 1+C_out), b2 (1+C_out,): OSG MLP with the
        equalized-lr scaling folded in.
      inbox: optional (M,) bbox mask (σ → -1e10 and rgb → 0 outside).
    Returns:
      rgb (M, C_out) f32, sigma (M, 1) f32.
    """
    if activation not in _ACTIVATIONS:
        raise ValueError(f'unknown activation {activation!r}')
    C = w1.shape[0]
    dt = rows.dtype
    tx = tx[..., None].to(dt)
    ty = ty[..., None].to(dt)
    live = live[..., None].to(dt)
    w00 = (1 - tx) * (1 - ty) * live
    w01 = tx * (1 - ty) * live
    w10 = (1 - tx) * ty * live
    w11 = tx * ty * live
    f = (w00 * rows[..., :C] + w01 * rows[..., C:2 * C]
         + w10 * rows[..., 2 * C:3 * C] + w11 * rows[..., 3 * C:])
    f = f.float()
    x = (f[0] + f[1] + f[2]) * (1.0 / 3.0)
    h = F.softplus(x @ w1.float() + b1.float())
    out = h @ w2.float() + b2.float()
    sigma = out[:, :1]
    rgb = out[:, 1:]
    if activation == 'sigmoid':
        rgb = torch.sigmoid(rgb) * 1.002 - 0.001
    else:
        rgb = F.leaky_relu(rgb, 0.2) * math.sqrt(2.0)
    if inbox is not None:
        m = inbox.float()[:, None]
        sigma = torch.where(m > 0, sigma, torch.full_like(sigma, -1e10))
        rgb = rgb * m
    return rgb, sigma


def _check(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if t.dtype not in dtypes:
        raise ValueError(f'{name}: dtype {t.dtype}, expected one of '
                         f'{dtypes}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')


def osg_pointwise_fused(rows, tx, ty, live, w1, b1, w2, b2,
                        activation: str = 'sigmoid', inbox=None):
    """Same contract as :func:`osg_pointwise_reference`.

    CPU tensors run the plain version.  Any other tensors are checked and
    then launch the kernel (counted in ``FusedOSG.launches``) or raise:
    rows must be contiguous bf16 or f32 of shape (3, M, 128),
    tx/ty/live/inbox f32, the weights f32 of shapes (32, 64), (64,),
    (64, 33), (33,), all on one CUDA device.
    """
    if rows.device.type == 'cpu':
        return osg_pointwise_reference(rows, tx, ty, live, w1, b1, w2, b2,
                                       activation=activation, inbox=inbox)
    if activation not in _ACTIVATIONS:
        raise ValueError(f'unknown activation {activation!r}')
    if rows.ndim != 3 or rows.shape[0] != 3:
        raise ValueError(f'rows: shape {tuple(rows.shape)}, expected '
                         '(3, M, 4C)')
    M = rows.shape[1]
    C, H, NO = KERNEL_C, KERNEL_HIDDEN, KERNEL_OUT
    f32 = (torch.float32,)
    _check('rows', rows, (3, M, 4 * C), (torch.bfloat16, torch.float32))
    for name, t in (('tx', tx), ('ty', ty), ('live', live)):
        _check(name, t, (3, M), f32)
    _check('w1', w1, (C, H), f32)
    _check('b1', b1, (H,), f32)
    _check('w2', w2, (H, NO), f32)
    _check('b2', b2, (NO,), f32)
    args = [tx, ty, live, w1, b1, w2, b2]
    if inbox is not None:
        _check('inbox', inbox, (M,), f32)
        args.append(inbox)
    for t in args:
        if t.device != rows.device:
            raise ValueError(f'all inputs must be on {rows.device}, got '
                             f'{t.device}')
    if rows.device.type != 'cuda':
        raise ValueError(f'fused_osg runs on CPU or CUDA tensors, got '
                         f'{rows.device}')
    if rows.data_ptr() % 16:
        raise ValueError('rows must be 16-byte aligned')

    rgb = torch.empty((M, NO - 1), dtype=torch.float32, device=rows.device)
    sigma = torch.empty((M, 1), dtype=torch.float32, device=rows.device)
    if M == 0:
        return rgb, sigma
    from ._build import LIBRARIES
    fn = _launcher(LIBRARIES.get('fused_osg'))
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = fn(rows.data_ptr(), int(rows.dtype == torch.bfloat16),
                 tx.data_ptr(), ty.data_ptr(), live.data_ptr(),
                 None if inbox is None else inbox.data_ptr(),
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 rgb.data_ptr(), sigma.data_ptr(), M,
                 _ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError(f'fused_osg kernel launch failed: CUDA error '
                           f'{err}')
    FusedOSG.launches += 1
    return rgb, sigma


def _launcher(lib: ctypes.CDLL):
    fn = lib.ln3diff_fused_osg_forward
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                       vp, ctypes.c_longlong, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
    return fn


class FusedOSG:
    """OSG MLP weights (equalized-lr scaling folded in) for the fused
    kernel; pass to ``render_rays(..., fused_osg=...)`` or use
    ``TriplaneVAE.render(..., use_fused_osg=True)``.

    ``FusedOSG.launches`` counts kernel launches (not plain-version calls)
    across all instances.
    """
    launches = 0

    def __init__(self, w1, b1, w2, b2, activation: str = 'sigmoid'):
        self.w1, self.b1, self.w2, self.b2 = w1, b1, w2, b2
        self.activation = activation

    def __call__(self, rows, tx, ty, live, inbox=None):
        """rows (B, 3, M, 4C), tx/ty/live (B, 3, M), inbox (B, M) →
        rgb (B, M, C_out), sigma (B, M, 1)."""
        outs = []
        for b in range(rows.shape[0]):
            outs.append(osg_pointwise_fused(
                rows[b], tx[b].float().contiguous(),
                ty[b].float().contiguous(), live[b].float().contiguous(),
                self.w1, self.b1, self.w2, self.b2,
                activation=self.activation,
                inbox=None if inbox is None else inbox[b].contiguous()))
        rgb = torch.stack([o[0] for o in outs])
        sigma = torch.stack([o[1] for o in outs])
        return rgb, sigma


def fused_osg_from_params(osg_state: dict, lr_multiplier: float = 1.0,
                          activation: str = 'sigmoid') -> FusedOSG:
    """Fold the EqualDense scaling (w·lr_mul/√fan_in, b·lr_mul) of an
    :class:`~ln3diff_tpu_torch.models.osg_decoder.OSGDecoder` state dict
    (``EqualDense_{0,1}.{weight,bias}``, weights ``(out, in)``) into plain
    f32 matrices ``w1 (C, H)``, ``w2 (H, 1+C_out)``."""
    k0 = osg_state['EqualDense_0.weight'].float()
    k1 = osg_state['EqualDense_1.weight'].float()
    return FusedOSG(
        w1=(k0.t() * (lr_multiplier / math.sqrt(k0.shape[1]))).contiguous(),
        b1=(osg_state['EqualDense_0.bias'].float()
            * lr_multiplier).contiguous(),
        w2=(k1.t() * (lr_multiplier / math.sqrt(k1.shape[1]))).contiguous(),
        b2=(osg_state['EqualDense_1.bias'].float()
            * lr_multiplier).contiguous(),
        activation=activation)
