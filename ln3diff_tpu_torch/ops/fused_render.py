"""Fused triplane point pipeline: bilinear lerp → plane mean → OSG MLP,
and its backward.

Port of ``ln3diff_tpu/ops/fused_render.py``: the forward kernel
``_kernel`` / ``_osg_forward`` (``:98,143``), the backward kernel
``_bwd_kernel`` / ``_osg_backward`` (``:219,323``) and the custom VJP that
joins them (``:412-441``), reached through ``osg_pointwise_fused``
``:446`` and ``FusedOSG.__call__`` ``:476``.

The corner rows are gathered by torch indexing
(:func:`~ln3diff_tpu_torch.render.renderer.packed_gather`); this module
turns the gathered rows into (rgb, σ) in one pass that writes only the
outputs.  ``osg_pointwise_reference`` is the plain PyTorch version and
repeats the kernel's arithmetic: with bf16 rows the lerp runs in bf16,
the plane mean and both layers in f32 (``fused_render.py:102-108``).
``osg_pointwise_backward_reference`` is the plain version of the backward
kernel, step by step as ``_bwd_kernel`` computes it.

``osg_pointwise_fused`` uses the plain version for CPU tensors (autograd
differentiates it) and for CUDA tensors runs :class:`_OSGFused`, whose
forward launches the CUDA kernel ``csrc/fused_osg.cu`` and whose backward
launches ``csrc/fused_osg_bwd.cu``; a CUDA tensor that the kernels do not
take raises.  Both kernels run on a persistent grid of one block per SM
(:func:`persistent_blocks`) that streams tiles of ``POINTS_PER_TILE``
points through a ring in shared memory.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from ._build import LIBRARIES, launch

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


def _activation(rgb_pre, activation):
    """(act(rgb_pre), act'(rgb_pre)) of the colour head."""
    if activation == 'sigmoid':
        s = torch.sigmoid(rgb_pre)
        return s * 1.002 - 0.001, s * (1.0 - s) * 1.002
    sqrt2 = math.sqrt(2.0)
    return (F.leaky_relu(rgb_pre, 0.2) * sqrt2,
            torch.where(rgb_pre >= 0, 1.0, 0.2) * sqrt2)


def osg_pointwise_backward_reference(rows, tx, ty, live, w1, b1, w2, b2,
                                     g_rgb, g_sigma,
                                     activation: str = 'sigmoid',
                                     inbox=None):
    """Plain version of the backward kernel (``_bwd_kernel``): the VJP of
    :func:`osg_pointwise_reference` for the cotangents ``g_rgb (M, C_out)``
    and ``g_sigma (M, 1)``.

    Returns ``(grows, gtx, gty, glive, ginbox, gw1, gb1, gw2, gb2)``:
    ``grows`` in the rows' dtype, the rest f32, ``ginbox`` None without an
    inbox.  It repeats the TPU kernel's arithmetic, which is not autograd
    of the forward: the lerp is recomputed in the rows' dtype, the row
    grads are ``w_k · round(g_f)`` in that dtype, while the per-corner sums
    that give the tx / ty / live grads take the f32 ``g_f`` against
    f32-widened corners, and the f32 tx, ty and live.
    """
    if activation not in _ACTIVATIONS:
        raise ValueError(f'unknown activation {activation!r}')
    C = w1.shape[0]
    dt = rows.dtype
    txf, tyf, livef = tx.float(), ty.float(), live.float()
    tx_d = txf[..., None].to(dt)
    ty_d = tyf[..., None].to(dt)
    live_d = livef[..., None].to(dt)
    w00 = (1 - tx_d) * (1 - ty_d) * live_d
    w01 = tx_d * (1 - ty_d) * live_d
    w10 = (1 - tx_d) * ty_d * live_d
    w11 = tx_d * ty_d * live_d
    c00, c01 = rows[..., :C], rows[..., C:2 * C]
    c10, c11 = rows[..., 2 * C:3 * C], rows[..., 3 * C:]
    f = (w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11).float()
    x = (f[0] + f[1] + f[2]) * (1.0 / 3.0)
    w1f, w2f = w1.float(), w2.float()
    hpre = x @ w1f + b1.float()
    h = F.softplus(hpre)
    out = h @ w2f + b2.float()
    rgb_act, act_d = _activation(out[:, 1:], activation)

    g_rgb_in = g_rgb.float()
    g_sig = g_sigma.float()
    ginbox = None
    if inbox is not None:
        m = inbox.float()[:, None]
        # rgb·m → d/dm = act(rgb_pre)·ĝ_rgb; σ's where(m > 0, ·, -1e10) is
        # flat in m and stops ĝ_σ outside
        ginbox = torch.sum(g_rgb_in * rgb_act, dim=-1)
        g_rgb_in = g_rgb_in * m
        g_sig = torch.where(m > 0, g_sig, torch.zeros_like(g_sig))
    g_out = torch.cat([g_sig, g_rgb_in * act_d], dim=1)

    gw2 = h.t() @ g_out
    gb2 = g_out.sum(0)
    g_hpre = (g_out @ w2f.t()) * torch.sigmoid(hpre)   # softplus' = sigmoid
    gw1 = x.t() @ g_hpre
    gb1 = g_hpre.sum(0)
    g_f = ((g_hpre @ w1f.t()) * (1.0 / 3.0))[None]    # the same ∀ planes

    g_fd = g_f.to(dt)
    grows = torch.cat([w00 * g_fd, w01 * g_fd, w10 * g_fd, w11 * g_fd],
                      dim=-1)
    g_w00 = torch.sum(g_f * c00.float(), dim=-1)
    g_w01 = torch.sum(g_f * c01.float(), dim=-1)
    g_w10 = torch.sum(g_f * c10.float(), dim=-1)
    g_w11 = torch.sum(g_f * c11.float(), dim=-1)
    gtx = livef * ((1 - tyf) * (g_w01 - g_w00) + tyf * (g_w11 - g_w10))
    gty = livef * ((1 - txf) * (g_w10 - g_w00) + txf * (g_w11 - g_w01))
    glive = ((1 - txf) * (1 - tyf) * g_w00 + txf * (1 - tyf) * g_w01
             + (1 - txf) * tyf * g_w10 + txf * tyf * g_w11)
    return grows, gtx, gty, glive, ginbox, gw1, gb1, gw2, gb2


def _check(name, t, shape, dtypes):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: shape {tuple(t.shape)}, expected '
                         f'{tuple(shape)}')
    if t.dtype not in dtypes:
        raise ValueError(f'{name}: dtype {t.dtype}, expected one of '
                         f'{dtypes}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: must be contiguous')


def _check_inputs(rows, tx, ty, live, w1, b1, w2, b2, activation, inbox,
                  extra=()):
    """Validate non-CPU inputs for the kernels.  ``extra``: further
    ``(name, tensor, trailing shape)`` f32 inputs of shape ``(M, *trailing
    shape)`` (the cotangents)."""
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
    for name, t, tail in extra:
        _check(name, t, (M, *tail), f32)
        args.append(t)
    for t in args:
        if t.device != rows.device:
            raise ValueError(f'all inputs must be on {rows.device}, got '
                             f'{t.device}')
    if rows.device.type != 'cuda':
        raise ValueError(f'fused_osg runs on CPU or CUDA tensors, got '
                         f'{rows.device}')
    # the kernels bulk-copy rows (and kernel 2 g_rgb) tile by tile
    aligned = [('rows', rows)] + [(n, t) for n, t, _ in extra if n == 'g_rgb']
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f'{name} must be 16-byte aligned')


# the kernels' tiles and rings, by rows' dtype (csrc/osg_common.cuh P;
# csrc/fused_osg.cu STAGES, csrc/fused_osg_bwd.cu GROUPS): points per tile,
# kernel 1's tiles in flight per block, and kernel 2's groups of four warps
# per block, each with its own stage
POINTS_PER_TILE = 64
FORWARD_STAGES = {torch.bfloat16: 3, torch.float32: 1}
BACKWARD_GROUPS = {torch.bfloat16: 2, torch.float32: 1}
# the weight grads, flat as kernel 2 writes them: gw1, gb1, gw2, gb2
_NW = (KERNEL_C * KERNEL_HIDDEN + KERNEL_HIDDEN
       + KERNEL_HIDDEN * KERNEL_OUT + KERNEL_OUT)
_VP = ctypes.c_void_p
# the C entry points' signatures, the stream last
_FWD_ARGTYPES = ([_VP, ctypes.c_int] + [_VP] * 10
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP])
_BWD_ARGTYPES = ([_VP, ctypes.c_int] + [_VP] * 16
                 + [ctypes.c_int, _VP, ctypes.c_longlong, ctypes.c_int, _VP])


def tiles(M: int) -> int:
    """Tiles of ``POINTS_PER_TILE`` points that cover M points (the last
    one ragged)."""
    return -(-M // POINTS_PER_TILE)


def persistent_blocks(M: int, sms: int) -> int:
    """Grid of either kernel: one block per SM (each block's ring and
    weights fill most of an SM's shared memory), at most one per tile.
    Block b takes tiles b, b + grid, ...; kernel 2 writes one set of
    weight-grad partials per group of consumer warps."""
    return max(1, min(tiles(M), sms))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def _blocks(M: int, device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    return persistent_blocks(M, _sm_count(idx))


def _launch_forward(rows, tx, ty, live, w1, b1, w2, b2, activation, inbox):
    """Kernel 1 on checked CUDA tensors → (rgb, sigma)."""
    M = rows.shape[1]
    dev = rows.device
    rgb = torch.empty((M, KERNEL_OUT - 1), dtype=torch.float32, device=dev)
    sigma = torch.empty((M, 1), dtype=torch.float32, device=dev)
    if M == 0:
        return rgb, sigma
    fn = LIBRARIES.function('fused_osg', 'ln3diff_fused_osg_forward',
                            _FWD_ARGTYPES)
    err = launch(dev, fn, rows.data_ptr(), int(rows.dtype == torch.bfloat16),
                 tx.data_ptr(), ty.data_ptr(), live.data_ptr(),
                 None if inbox is None else inbox.data_ptr(),
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 rgb.data_ptr(), sigma.data_ptr(), M,
                 _ACTIVATIONS[activation], _blocks(M, dev))
    if err != 0:
        raise RuntimeError(f'fused_osg kernel launch failed: CUDA error '
                           f'{err}')
    FusedOSG.launches += 1
    return rgb, sigma


def _launch_backward(rows, tx, ty, live, w1, b1, w2, b2, g_rgb, g_sigma,
                     activation, inbox):
    """Kernel 2 on checked CUDA tensors → the nine outputs of
    :func:`osg_pointwise_backward_reference`."""
    M = rows.shape[1]
    dev = rows.device
    f32 = dict(dtype=torch.float32, device=dev)
    C, H, NO = KERNEL_C, KERNEL_HIDDEN, KERNEL_OUT
    grows = torch.empty_like(rows)
    gtx, gty, glive = (torch.empty((3, M), **f32) for _ in range(3))
    ginbox = None if inbox is None else torch.empty((M,), **f32)
    # every element is written by the reduce kernel; zero without points
    wgrad = (torch.empty if M > 0 else torch.zeros)((_NW,), **f32)
    if M > 0:
        nblocks = _blocks(M, dev)
        partials = torch.empty(
            (nblocks * BACKWARD_GROUPS[rows.dtype] * _NW,), **f32)
        fn = LIBRARIES.function('fused_osg_bwd', 'ln3diff_fused_osg_backward',
                                _BWD_ARGTYPES)
        err = launch(dev, fn, rows.data_ptr(),
                     int(rows.dtype == torch.bfloat16), tx.data_ptr(),
                     ty.data_ptr(), live.data_ptr(),
                     None if inbox is None else inbox.data_ptr(),
                     w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                     b2.data_ptr(), g_rgb.data_ptr(), g_sigma.data_ptr(),
                     grows.data_ptr(), gtx.data_ptr(), gty.data_ptr(),
                     glive.data_ptr(),
                     None if ginbox is None else ginbox.data_ptr(),
                     partials.data_ptr(), nblocks, wgrad.data_ptr(), M,
                     _ACTIVATIONS[activation])
        if err != 0:
            raise RuntimeError(f'fused_osg backward kernel launch failed: '
                               f'CUDA error {err}')
        FusedOSG.backward_launches += 1
    gw1 = wgrad[:C * H].view(C, H)
    gb1 = wgrad[C * H:C * H + H]
    gw2 = wgrad[C * H + H:C * H + H + H * NO].view(H, NO)
    gb2 = wgrad[C * H + H + H * NO:]
    return grows, gtx, gty, glive, ginbox, gw1, gb1, gw2, gb2


class _OSGFused(torch.autograd.Function):
    """Kernel 1 with kernel 2 as its backward, for CUDA tensors (the custom
    VJP ``_osg_fused`` of ``fused_render.py:412-441``).  The forward saves
    only its inputs; the backward recomputes the forward inside kernel 2."""

    @staticmethod
    def forward(ctx, rows, tx, ty, live, w1, b1, w2, b2, inbox, activation):
        ctx.activation = activation
        ctx.save_for_backward(rows, tx, ty, live, w1, b1, w2, b2, inbox)
        return _launch_forward(rows, tx, ty, live, w1, b1, w2, b2,
                               activation, inbox)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_rgb, g_sigma):
        rows, tx, ty, live, w1, b1, w2, b2, inbox = ctx.saved_tensors
        M = rows.shape[1]
        if g_rgb is None:
            g_rgb = torch.zeros((M, KERNEL_OUT - 1), device=rows.device)
        if g_sigma is None:
            g_sigma = torch.zeros((M, 1), device=rows.device)
        g_rgb = g_rgb.float().contiguous()
        if g_rgb.data_ptr() % 16:          # a view that starts mid-row
            g_rgb = g_rgb.clone()
        grads = _launch_backward(
            rows, tx, ty, live, w1, b1, w2, b2, g_rgb,
            g_sigma.float().contiguous(), ctx.activation, inbox)
        grows, gtx, gty, glive, ginbox, gw1, gb1, gw2, gb2 = grads
        return (grows, gtx.to(tx.dtype), gty.to(ty.dtype),
                glive.to(live.dtype), gw1.to(w1.dtype), gb1.to(b1.dtype),
                gw2.to(w2.dtype), gb2.to(b2.dtype),
                None if inbox is None else ginbox.to(inbox.dtype), None)


def osg_pointwise_fused(rows, tx, ty, live, w1, b1, w2, b2,
                        activation: str = 'sigmoid', inbox=None):
    """Same contract as :func:`osg_pointwise_reference`, differentiable.

    CPU tensors run the plain version (autograd differentiates it).  Any
    other tensors are checked and then go through :class:`_OSGFused`: the
    forward launches kernel 1 (counted in ``FusedOSG.launches``), the
    backward kernel 2 (``FusedOSG.backward_launches``); anything else
    raises.  rows must be contiguous bf16 or f32 of shape (3, M, 128),
    tx/ty/live/inbox f32, the weights f32 of shapes (32, 64), (64,),
    (64, 33), (33,), all on one CUDA device.
    """
    if rows.device.type == 'cpu':
        return osg_pointwise_reference(rows, tx, ty, live, w1, b1, w2, b2,
                                       activation=activation, inbox=inbox)
    _check_inputs(rows, tx, ty, live, w1, b1, w2, b2, activation, inbox)
    return _OSGFused.apply(rows, tx, ty, live, w1, b1, w2, b2, inbox,
                           activation)


def osg_pointwise_backward(rows, tx, ty, live, w1, b1, w2, b2, g_rgb,
                           g_sigma, activation: str = 'sigmoid', inbox=None):
    """Same contract as :func:`osg_pointwise_backward_reference`.

    CPU tensors run the plain version; CUDA tensors are checked as in
    :func:`osg_pointwise_fused` (plus ``g_rgb (M, 32)`` and
    ``g_sigma (M, 1)`` f32, contiguous) and launch kernel 2, or raise."""
    if rows.device.type == 'cpu':
        return osg_pointwise_backward_reference(
            rows, tx, ty, live, w1, b1, w2, b2, g_rgb, g_sigma,
            activation=activation, inbox=inbox)
    _check_inputs(rows, tx, ty, live, w1, b1, w2, b2, activation, inbox,
                  extra=(('g_rgb', g_rgb, (KERNEL_OUT - 1,)),
                         ('g_sigma', g_sigma, (1,))))
    return _launch_backward(rows, tx, ty, live, w1, b1, w2, b2, g_rgb,
                            g_sigma, activation, inbox)


class FusedOSG:
    """OSG MLP weights (equalized-lr scaling folded in) for the fused
    kernel; pass to ``render_rays(..., fused_osg=...)`` or use
    ``TriplaneVAE.render(..., use_fused_osg=True)``.

    ``FusedOSG.launches`` counts launches of the forward kernel and
    ``FusedOSG.backward_launches`` of the backward kernel (not
    plain-version calls), across all instances.
    """
    launches = 0
    backward_launches = 0

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


def fused_osg_from_params(osg_params: dict, lr_multiplier: float = 1.0,
                          activation: str = 'sigmoid') -> FusedOSG:
    """Fold the EqualDense scaling (w·lr_mul/√fan_in, b·lr_mul) of an
    :class:`~ln3diff_tpu_torch.models.osg_decoder.OSGDecoder`'s
    ``EqualDense_{0,1}.{weight,bias}`` (weights ``(out, in)``) into plain
    f32 matrices ``w1 (C, H)``, ``w2 (H, 1+C_out)``.

    Pass the module's parameters (``dict(dec.named_parameters())``) to
    train through the result: the folding is differentiable, so grads
    reach them.  A ``state_dict()`` holds detached copies."""
    k0 = osg_params['EqualDense_0.weight'].float()
    k1 = osg_params['EqualDense_1.weight'].float()
    return FusedOSG(
        w1=(k0.t() * (lr_multiplier / math.sqrt(k0.shape[1]))).contiguous(),
        b1=(osg_params['EqualDense_0.bias'].float()
            * lr_multiplier).contiguous(),
        w2=(k1.t() * (lr_multiplier / math.sqrt(k1.shape[1]))).contiguous(),
        b2=(osg_params['EqualDense_1.bias'].float()
            * lr_multiplier).contiguous(),
        activation=activation)
