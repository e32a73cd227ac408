"""Serving across ranks: the render workload and the denoiser sharded.

Port of ``ln3diff_tpu/parallel/serving.py``: ``tp_shard_denoiser_params``
:33, ``shard_orbit_render`` :50 and ``shard_points_query`` :78.  The
text→mesh tail is parallel along two axes that the denoiser's loop is
not: the orbit's frames are independent renders of the same planes, and
the σ grid's points are independent decoder queries.  Both split over the
mesh's ``data`` ranks — planes replicated, each rank running the
single-device path (the fused kernel included) on its frames or points —
and are gathered back, so every rank holds the whole result.

Tensor parallelism splits the denoiser's projections over the
``tensor`` ranks by ``tensor_parallel_rules``.  GSPMD splits JAX's
``(in, 3·D)`` qkv kernel logically; a torch row block of the ``(3·D, in)``
weight would hand rank r a contiguous third of q|k|v instead of its own
heads' q, k and v, so each rank's qkv rows are gathered per head
(Megatron's layout): rank r holds the q, k and v rows of heads ``[r·H/tp,
(r+1)·H/tp)`` and its attention runs on those heads.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

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

class ColumnParallelLinear(nn.Module):
    """The rank's output rows ``rows`` of a Linear; ``gather``: the whole
    output, gathered over the tensor ranks (when the next layer reads all
    of it)."""

    def __init__(self, linear: nn.Linear, rows: torch.Tensor, g, n: int,
                 gather: bool):
        super().__init__()
        self.weight = nn.Parameter(linear.weight.detach()[rows].clone(),
                                   requires_grad=False)
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.detach()[rows].clone(), requires_grad=False)
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
        self.weight = nn.Parameter(linear.weight.detach()[:, cols].clone(),
                                   requires_grad=False)
        self.bias = None if linear.bias is None else nn.Parameter(
            linear.bias.detach().clone(), requires_grad=False)
        self.register_buffer('cols', cols, persistent=False)
        self.g, self.scatter = g, scatter

    def forward(self, x):
        if self.scatter:
            x = x.index_select(-1, self.cols)
        y = F.linear(x, self.weight)
        dist.all_reduce(y, group=self.g)
        return y if self.bias is None else y + self.bias


def _block(size: int, n: int, r: int) -> torch.Tensor:
    k = size // n
    return torch.arange(r * k, (r + 1) * k)


def tp_shard_denoiser_params(model: nn.Module, mesh,
                             min_size_to_shard: int = 2**16) -> nn.Module:
    """Split ``model``'s Linear layers over the mesh's ``tensor`` ranks by
    ``tensor_parallel_rules`` (JAX :33), in place, for sampling.

    A column-parallel layer keeps its rank's output rows, a row-parallel
    one its input columns and all-reduces its output.  Where a pair splits
    together — an attention's input projections with its output
    projection (a head count divisible by tp), or ``fc1`` with ``fc2`` —
    the activation between them stays split: the attention runs on the
    rank's heads (``num_heads / tp``).  A split layer whose partner is not
    split gathers its output (column) or takes its columns of a whole
    input (row), so every mix of the rules' choices computes the same
    function.  Int8 layers and convolutions stay whole.  Returns
    ``model``."""
    tp = axis_size(mesh, 'tensor')
    if tp == 1:
        return model
    if not is_distributed(mesh):
        raise ValueError('tensor parallelism needs a process group')
    g, r = group(mesh, 'tensor'), axis_index(mesh, 'tensor')
    t_i = AXES.index('tensor')
    rules = tensor_parallel_rules(model, mesh, min_size_to_shard)
    modules = dict(model.named_modules())

    def split(name):
        """'col', 'row' or None for the Linear ``name``."""
        lin = modules.get(name)
        if type(lin) is not nn.Linear:
            return None
        pl = rules.get(f'{name}.weight')
        if pl is None or not pl[t_i].is_shard():
            return None
        return 'col' if pl[t_i].dim == 0 else 'row'

    def replace(name, new):
        parent, _, leaf = name.rpartition('.')
        setattr(modules[parent] if parent else model, leaf, new)

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
            lin = modules[prefix + i]
            rows = _block(lin.out_features, tp, r)
            if i == 'qkv' and paired:
                D = lin.out_features // 3
                rows = torch.cat([j * D + _block(D, tp, r)
                                  for j in range(3)])
            replace(prefix + i, ColumnParallelLinear(
                lin, rows.to(lin.weight.device), g, tp, gather=not paired))
            done.add(prefix + i)
        if split(prefix + out) == 'row':
            lin = modules[prefix + out]
            cols = _block(lin.in_features, tp, r).to(lin.weight.device)
            replace(prefix + out, RowParallelLinear(lin, cols, g,
                                                    scatter=not paired))
            done.add(prefix + out)
        if paired and hasattr(mod, 'num_heads'):
            mod.num_heads //= tp
    for name in modules:
        kind = split(name)
        if kind is None or name in done:
            continue
        lin = modules[name]
        if kind == 'col':
            rows = _block(lin.out_features, tp, r).to(lin.weight.device)
            replace(name, ColumnParallelLinear(lin, rows, g, tp, True))
        else:
            cols = _block(lin.in_features, tp, r).to(lin.weight.device)
            replace(name, RowParallelLinear(lin, cols, g, True))
    return model
