"""Serving across ranks: the render workload and the denoiser sharded.

Port of ``ln3diff_tpu/parallel/serving.py``: ``tp_shard_denoiser_params``
:33, ``shard_orbit_render`` :50 and ``shard_points_query`` :78.  The
text→mesh tail is parallel along two axes that the denoiser's loop is
not: the orbit's frames are independent renders of the same planes, and
the σ grid's points are independent decoder queries.  Both split over the
mesh's ``data`` ranks — planes replicated, each rank running the
single-device path (the fused kernel included) on its frames or points —
and are gathered back, so every rank holds the whole result.

Tensor parallelism splits the denoiser's layers over the ``tensor`` ranks
by ``tensor_parallel_rules``: every layer whose kernel the rules place on
'tensor' — a float ``Linear``, an int8 ``Int8Linear`` (its ``kernel_q``),
a float or int8 conv, the U-Net's 1x1 ``proj_in``/``proj_out`` and ADM
``qkv``/``proj`` among them — is replaced by its column- or row-parallel
module, so each rank holds only its shard; a layer the rules shard that
has no split module raises.  GSPMD splits JAX's ``(in, 3·D)`` qkv kernel
logically; a torch row block of the ``(3·D, in)`` weight would hand rank
r a contiguous third of q|k|v instead of its own heads' q, k and v, so
each rank's qkv rows are gathered per head (Megatron's layout): rank r
holds the q, k and v rows of heads ``[r·H/tp, (r+1)·H/tp)`` (and an int8
qkv the same rows of ``kernel_q``, ``scale`` and ``bias``), and its
attention runs on those heads.

A split int8 layer equals the one-rank layer bit for bit.  A column
shard quantizes the whole input as the whole layer does and keeps its
output rows of ``kernel_q``, ``scale`` and ``bias``, so its output is the
matching slice of the whole output.  A row shard multiplies its columns
of the int8 activations by its columns of ``kernel_q`` into a partial
**int32** accumulator; the partials are all-reduced (SUM) in int32,
which is exact, and only the sum is rescaled by ``x_scale · w_scale``
and given the bias, once — what GSPMD makes of JAX's int32
``dot_general`` with its contraction axis sharded.  The activation scale
is the whole layer's: a whole input is quantized whole before the rank
takes its columns, and an input that arrives split (after a column
layer) has its per-token amax — per sample for an ``Int8Conv`` —
MAX-reduced over the ranks first.  The pieces are pure functions of
``ops/int8.py`` (``column_shard``, ``row_shard``,
``int8_dense_row_partial``, ``int8_conv_row_partial``) that take no
process group.  A float row shard's partial sums add in another order
than the whole layer's (within f32 or bf16 rounding).  On CUDA an int8
shard's GEMM widths must be multiples of 8 (``check_int8_shard``); the
released widths split cleanly at tp = 2, 4 and 8.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..ops.int8 import (Int8Conv, Int8Linear, Int8Module, check_int8_shard,
                        column_shard, int8_conv, int8_conv_row_partial,
                        int8_dense, int8_dense_row_partial, int8_rescale,
                        row_shard)
from .mesh import (AXES, axis_index, axis_size, group, is_distributed,
                   tensor_parallel_rules)


def _gather(x: torch.Tensor, g, n: int, dim: int) -> torch.Tensor:
    if n == 1 and g is None:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=dim)


def shard_orbit_render(render_fn, mesh, axis: str = 'data'):
    """Wrap ``render_fn(planes_f, cams) -> (F, H, W, C)`` so that the
    frame axis is split over ``axis`` of ``mesh``.  Returns ``fn(planes,
    cams)``: ``planes`` (1, ...) the same on every rank, broadcast to the
    rank's frames; ``cams`` (F, 25) with F divisible by the axis size (pad
    the cyclic orbit if needed); the frames gathered back in order."""
    n = axis_size(mesh, axis)
    g = group(mesh, axis)

    def fn(planes, cams):
        if cams.shape[0] % n:
            raise ValueError(f'frame count {cams.shape[0]} not divisible by '
                             f'mesh axis {n}')
        k = cams.shape[0] // n
        r = axis_index(mesh, axis)
        local = cams[r * k:(r + 1) * k]
        planes_f = planes.repeat_interleave(k, dim=0)
        return _gather(render_fn(planes_f, local), g, n, 0)

    return fn


def shard_points_query(point_fn, mesh, axis: str = 'data',
                       chunk: int = 2**16):
    """Wrap ``point_fn(planes, coords) -> (rgb, sigma)`` so that the point
    axis is split over ``axis``.  ``coords`` (1, N, 3); N is padded to a
    multiple of the axis size with the first point (decoders are pure
    per-point functions, so any in-box point will do) and the result cut
    back to N; each rank decodes its points in chunks of ``chunk``."""
    n = axis_size(mesh, axis)
    g = group(mesh, axis)

    def fn(planes, coords):
        N = coords.shape[1]
        pad = (-N) % n
        if pad:
            coords = torch.cat([coords, coords[:, :1].expand(1, pad, 3)],
                               dim=1)
        k = coords.shape[1] // n
        r = axis_index(mesh, axis)
        local = coords[:, r * k:(r + 1) * k]
        outs = [point_fn(planes, local[:, s:s + chunk])
                for s in range(0, k, chunk)]
        rgb = torch.cat([o[0] for o in outs], dim=1)
        sigma = torch.cat([o[1] for o in outs], dim=1)
        return (_gather(rgb, g, n, 1)[:, :N],
                _gather(sigma, g, n, 1)[:, :N])

    return fn


# ---------------------------------------------------------------------------
# tensor-parallel denoiser
# ---------------------------------------------------------------------------

def _all_reduce(y: torch.Tensor, g) -> torch.Tensor:
    dist.all_reduce(y, group=g)
    return y


def _amax_reduce(g):
    """The MAX all-reduce of a row shard's local activation amax."""
    def reduce(amax):
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
        return amax
    return reduce


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.detach().clone(), requires_grad=False)


class ColumnParallelLinear(nn.Module):
    """The rank's output rows ``rows`` of a Linear; ``gather``: the whole
    output, gathered over the tensor ranks (when the next layer reads all
    of it)."""

    def __init__(self, linear: nn.Linear, rows: torch.Tensor, g, n: int,
                 gather: bool):
        super().__init__()
        self.weight = _frozen(linear.weight[rows])
        self.bias = None if linear.bias is None else _frozen(
            linear.bias[rows])
        self.g, self.n, self.gather = g, n, gather

    def forward(self, x):
        y = F.linear(x, self.weight, self.bias)
        return _gather(y, self.g, self.n, -1) if self.gather else y


class RowParallelLinear(nn.Module):
    """The rank's input columns ``cols`` of a Linear: partial products
    summed over the tensor ranks, then the bias.  ``scatter``: the input is
    whole (the previous layer was not split) and the rank takes its
    columns."""

    def __init__(self, linear: nn.Linear, cols: torch.Tensor, g,
                 scatter: bool):
        super().__init__()
        self.weight = _frozen(linear.weight[:, cols])
        self.bias = None if linear.bias is None else _frozen(linear.bias)
        self.register_buffer('cols', cols, persistent=False)
        self.g, self.scatter = g, scatter

    def forward(self, x):
        if self.scatter:
            x = x.index_select(-1, self.cols)
        y = _all_reduce(F.linear(x, self.weight), self.g)
        return y if self.bias is None else y + self.bias


class ColumnParallelConv2d(ColumnParallelLinear):
    """The rank's output channels ``rows`` of a Conv2d (NCHW); ``gather``:
    the whole output, gathered on the channel axis."""

    def __init__(self, conv: nn.Conv2d, rows, g, n: int, gather: bool):
        super().__init__(conv, rows, g, n, gather)
        self.stride, self.padding = conv.stride, conv.padding
        self.weight.data = self.weight.data.contiguous(
            memory_format=torch.channels_last)

    def forward(self, x):
        y = F.conv2d(x, self.weight, self.bias, self.stride, self.padding)
        return _gather(y, self.g, self.n, 1) if self.gather else y


class RowParallelConv2d(RowParallelLinear):
    """The rank's input channels ``cols`` of a Conv2d: partial convolutions
    summed over the tensor ranks, then the bias; ``scatter``: the input is
    whole and the rank takes its channels."""

    def __init__(self, conv: nn.Conv2d, cols, g, scatter: bool):
        super().__init__(conv, cols, g, scatter)
        self.stride, self.padding = conv.stride, conv.padding
        self.weight.data = self.weight.data.contiguous(
            memory_format=torch.channels_last)

    def forward(self, x):
        if self.scatter:
            x = x.index_select(1, self.cols)
        y = _all_reduce(F.conv2d(x, self.weight, None, self.stride,
                                 self.padding), self.g)
        return y if self.bias is None else y + self.bias.view(1, -1, 1, 1)


class ColumnParallelInt8Linear(Int8Module):
    """The rank's output rows ``rows`` of an :class:`Int8Linear`:
    ``kernel_q``, ``scale`` and ``bias`` sliced alike.  The whole input is
    quantized as the whole layer quantizes it, so the output is the
    matching slice of the whole layer's, bit for bit; ``gather``: the
    whole output, gathered."""

    def __init__(self, layer: Int8Linear, rows, g, n: int, gather: bool):
        kernel_q, scale, bias = column_shard(layer, rows)
        super().__init__(tuple(kernel_q.shape), bias is not None)
        self.kernel_q, self.scale = kernel_q.clone(), scale.clone()
        if bias is not None:
            self.bias = bias.clone()
        self.g, self.n, self.gather = g, n, gather

    def forward(self, x):
        y = int8_dense(x, self.kernel_q, self.scale, self.bias)
        return _gather(y, self.g, self.n, -1) if self.gather else y


class RowParallelInt8Linear(Int8Module):
    """The rank's input columns ``cols`` of an :class:`Int8Linear`;
    ``scale`` and ``bias`` whole.  The int32 partial accumulators are
    summed over the tensor ranks in int32 — exact — and only the sum is
    rescaled and the bias added, so the output equals the whole layer's
    bit for bit.  The activation scale is the whole layer's: ``scatter``
    (a whole input) quantizes the whole row and takes the rank's columns;
    otherwise the per-token amax is MAX-reduced over the ranks first."""

    def __init__(self, layer: Int8Linear, cols, g, scatter: bool):
        kernel_q = row_shard(layer, cols)
        super().__init__(tuple(kernel_q.shape), layer.bias is not None)
        self.kernel_q, self.scale = kernel_q.clone(), layer.scale.clone()
        if layer.bias is not None:
            self.bias = layer.bias.clone()
        self.register_buffer('cols', cols, persistent=False)
        self.g, self.scatter = g, scatter

    def forward(self, x):
        acc, x_scale = int8_dense_row_partial(
            x, self.kernel_q, cols=self.cols if self.scatter else None,
            amax_reduce=_amax_reduce(self.g))
        return int8_rescale(_all_reduce(acc, self.g), x_scale, self.scale,
                            self.bias, x.dtype)


class ColumnParallelInt8Conv(ColumnParallelInt8Linear):
    """The rank's output channels of an :class:`Int8Conv` (one activation
    scale per sample, the whole input's); ``gather``: the whole output,
    gathered on the channel axis."""

    def __init__(self, conv: Int8Conv, rows, g, n: int, gather: bool):
        super().__init__(conv, rows, g, n, gather)
        self.stride, self.padding = conv.stride, conv.padding

    def forward(self, x):
        y = int8_conv(x, self.kernel_q, self.scale, self.bias, self.stride,
                      self.padding)
        return _gather(y, self.g, self.n, 1) if self.gather else y


class RowParallelInt8Conv(RowParallelInt8Linear):
    """The rank's input channels of an :class:`Int8Conv`: the int32
    partial convolutions summed in int32 over the ranks, then rescaled;
    the per-sample activation scale is the whole input's (``scatter``: the
    whole input quantized, then the rank's channels; else the per-sample
    amax MAX-reduced)."""

    def __init__(self, conv: Int8Conv, cols, g, scatter: bool):
        super().__init__(conv, cols, g, scatter)
        self.stride, self.padding = conv.stride, conv.padding

    def forward(self, x):
        acc, x_scale = int8_conv_row_partial(
            x, self.kernel_q, self.stride, self.padding,
            cols=self.cols if self.scatter else None,
            amax_reduce=_amax_reduce(self.g))
        return int8_rescale(_all_reduce(acc, self.g), x_scale, self.scale,
                            self.bias, x.dtype).permute(0, 3, 1, 2)


# the split classes of each layer type that the rules may place on
# 'tensor': (column-parallel, row-parallel)
SPLITS = {nn.Linear: (ColumnParallelLinear, RowParallelLinear),
          nn.Conv2d: (ColumnParallelConv2d, RowParallelConv2d),
          Int8Linear: (ColumnParallelInt8Linear, RowParallelInt8Linear),
          Int8Conv: (ColumnParallelInt8Conv, RowParallelInt8Conv)}
SPLIT_CLASSES = tuple(c for pair in SPLITS.values() for c in pair)


def _widths(layer: nn.Module):
    """``(in, out)`` widths of a Linear or conv layer."""
    if isinstance(layer, (nn.Linear, Int8Linear)):
        return layer.in_features, layer.out_features
    return layer.in_channels, layer.out_channels


def _split_layer(name: str, layer: nn.Module, kind: str, idx, g, n: int,
                 whole_io: bool) -> nn.Module:
    """``layer`` split ``kind`` ('col' or 'row') to the rank's output rows
    or input columns ``idx``; ``whole_io``: gather the column layer's
    output / scatter the row layer's whole input.  An int8 shard's GEMM
    widths are checked first (:func:`check_int8_shard`)."""
    col_cls, row_cls = SPLITS[type(layer)]
    if isinstance(layer, Int8Module):
        fan_in, fan_out = _widths(layer)
        k2 = layer.kernel_q[0, 0].numel()        # a conv's kh·kw, else 1
        check_int8_shard(name, (fan_in if kind == 'col' else len(idx)) * k2,
                         len(idx) if kind == 'col' else fan_out,
                         layer.kernel_q.device)
    if kind == 'col':
        return col_cls(layer, idx, g, n, gather=whole_io)
    return row_cls(layer, idx, g, scatter=whole_io)


def _block(size: int, n: int, r: int) -> torch.Tensor:
    k = size // n
    return torch.arange(r * k, (r + 1) * k)


def tp_shard_denoiser_params(model: nn.Module, mesh,
                             min_size_to_shard: int = 2**16) -> nn.Module:
    """Split ``model``'s layers over the mesh's ``tensor`` ranks by
    ``tensor_parallel_rules`` (JAX :33), in place, for sampling.

    Every layer whose kernel the rules place on ``tensor`` is replaced by
    its split module — a float or int8 Linear, a float or int8 conv
    (:data:`SPLITS`) — so each rank holds only its shard; a layer of any
    other type under the rules raises.  A column-parallel layer keeps its
    rank's output rows, a row-parallel one its input columns and
    all-reduces its output (an int8 one its int32 accumulator).  Where a
    pair splits together — an attention's input projections with its
    output projection (a head count divisible by tp), or ``fc1`` with
    ``fc2`` — the activation between them stays split: the attention runs
    on the rank's heads (``num_heads / tp``).  A split layer whose partner
    is not split gathers its output (column) or takes its columns of a
    whole input (row), so every mix of the rules' choices computes the
    same function: the U-Net's ``proj_in`` gathers its channels for the
    transformer blocks, which read the whole width, and ``proj_out`` takes
    its channels of their whole output.  Returns ``model``."""
    tp = axis_size(mesh, 'tensor')
    if tp == 1:
        return model
    if not is_distributed(mesh):
        raise ValueError('tensor parallelism needs a process group')
    g, r = group(mesh, 'tensor'), axis_index(mesh, 'tensor')
    t_i = AXES.index('tensor')
    rules = tensor_parallel_rules(model, mesh, min_size_to_shard)
    sharded = {name.rpartition('.')[0] for name, pl in rules.items()
               if pl[t_i].is_shard()}
    modules = dict(model.named_modules())

    def split(name):
        """'col', 'row' or None for the layer ``name``."""
        layer = modules.get(name)
        if name not in sharded or type(layer) not in SPLITS:
            return None
        kernel = 'kernel_q' if isinstance(layer, Int8Module) else 'weight'
        return 'col' if rules[f'{name}.{kernel}'][t_i].dim == 0 else 'row'

    def replace(name, new):
        parent, _, leaf = name.rpartition('.')
        setattr(modules[parent] if parent else model, leaf, new)

    def kernel_device(layer):
        return (layer.kernel_q if isinstance(layer, Int8Module)
                else layer.weight).device

    done = set()
    for pname, mod in list(modules.items()):
        prefix = f'{pname}.' if pname else ''
        if hasattr(mod, 'qkv') and hasattr(mod, 'proj') \
                and hasattr(mod, 'num_heads'):
            ins, out = ['qkv'], 'proj'
        elif hasattr(mod, 'to_q') and hasattr(mod, 'to_out') \
                and hasattr(mod, 'num_heads'):
            ins, out = ['to_q', 'to_k', 'to_v'], 'to_out'
        elif hasattr(mod, 'fc1') and hasattr(mod, 'fc2'):
            ins, out = ['fc1'], 'fc2'
        else:
            continue
        kinds = [split(prefix + i) for i in ins]
        heads_ok = getattr(mod, 'num_heads', tp) % tp == 0
        paired = all(k == 'col' for k in kinds) \
            and split(prefix + out) == 'row' and heads_ok
        for i, kind in zip(ins, kinds):
            if kind != 'col':
                continue
            layer = modules[prefix + i]
            width = _widths(layer)[1]
            rows = _block(width, tp, r)
            if i == 'qkv' and paired:
                # Megatron's layout: the q, k and v rows of the rank's heads
                D = width // 3
                rows = torch.cat([j * D + _block(D, tp, r)
                                  for j in range(3)])
            replace(prefix + i, _split_layer(
                prefix + i, layer, 'col', rows.to(kernel_device(layer)), g,
                tp, whole_io=not paired))
            done.add(prefix + i)
        if split(prefix + out) == 'row':
            layer = modules[prefix + out]
            cols = _block(_widths(layer)[0], tp, r).to(kernel_device(layer))
            replace(prefix + out, _split_layer(prefix + out, layer, 'row',
                                               cols, g, tp,
                                               whole_io=not paired))
            done.add(prefix + out)
        if paired and hasattr(mod, 'num_heads'):
            mod.num_heads //= tp
    for name in modules:
        kind = split(name)
        if kind is None or name in done:
            continue
        layer = modules[name]
        width = _widths(layer)[0 if kind == 'row' else 1]
        idx = _block(width, tp, r).to(kernel_device(layer))
        replace(name, _split_layer(name, layer, kind, idx, g, tp, True))
    # none of the layers that the rules shard may stay whole
    now = dict(model.named_modules())
    whole = sorted(n for n in sharded if not isinstance(now.get(n),
                                                        SPLIT_CLASSES))
    if whole:
        raise ValueError(f'tensor_parallel_rules shard {whole}, of types '
                         f'{sorted({type(now.get(n)).__name__ for n in whole})}'
                         f', which have no split module')
    return model
