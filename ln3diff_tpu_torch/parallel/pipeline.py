"""GPipe-style pipeline parallelism over the DiT's trunk of blocks.

Port of ``ln3diff_tpu/parallel/pipeline.py`` (``pipeline_blocks`` :47,
``_pipeline_pp1`` :145, ``split_stages`` :161, ``dit_pipeline_apply``
:171).  The mesh's ``pipe`` axis splits the trunk into ``pp`` stages of
contiguous blocks: stage ``s`` of a depth-``L`` trunk owns blocks ``[s·L/pp,
(s+1)·L/pp)``.  The batch splits into ``n_micro`` microbatches that flow
through the stages: stage ``s`` runs microbatch ``m`` at tick ``m + s``
of the ``n_micro + pp − 1`` ticks, receiving it from stage ``s − 1`` and
sending its result on to ``s + 1`` (point-to-point over the pipe group,
tagged by microbatch); a stage computes nothing in its bubble ticks.

Autograd runs the mirrored backward pipeline: each send's backward
receives the gradient of what it sent, each receive's backward sends the
gradient back.  The last stage's outputs go to every stage (a broadcast
whose backward hands the cotangent to the last stage alone, since every
stage computes the same loss from them), and the inputs of the schedule —
the tokens and the per-sample context, the same on every stage — have
their cotangents summed over the stages, as JAX's autodiff does for
pipe-invariant inputs of its ``shard_map``.  The schedule's data movement
is f32, as in JAX (:85-94); the blocks compute in their own dtype.

A stage runs, and holds, its own blocks only: under a trainer's
``TrainState`` the other stages' blocks sit on the ``meta`` device (JAX
shards the stacked layer axis, so a device there holds only its stage's
blocks), and nothing here reads them.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from .mesh import axis_index, axis_size, group, tree_map

def _pending_sends(mesh) -> list:
    """The sends in flight of ``mesh``'s schedules, (work, buffer) pairs
    kept until the next schedule on the mesh waits for them."""
    return mesh.__dict__.setdefault('_pending_sends', [])


def _finish_sends(pending: list):
    while pending:
        work, _ = pending.pop()
        work.wait()


def _isend(t: torch.Tensor, dst: int, g, tag: int, pending: list):
    t = t.contiguous()
    pending.append((dist.isend(t, dst, group=g, tag=tag), t))


class _Send(torch.autograd.Function):
    """Send ``y`` to the next stage; the returned empty token carries the
    backward pass, which receives ``y``'s gradient from that stage."""

    @staticmethod
    def forward(ctx, y, dst, g, tag, pending):
        ctx.meta = (y.shape, y.dtype, y.device, dst, g, tag)
        _isend(y.detach(), dst, g, tag, pending)
        return y.new_empty(0)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, src, g, tag = ctx.meta
        grad = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(grad, src, group=g, tag=tag)
        return grad, None, None, None, None


class _Recv(torch.autograd.Function):
    """Receive the previous stage's activation; the backward pass sends
    its gradient back."""

    @staticmethod
    def forward(ctx, anchor, shape, src, g, tag, pending):
        ctx.meta = (src, g, tag, pending)
        out = torch.empty(shape, dtype=anchor.dtype, device=anchor.device)
        dist.recv(out, src, group=g, tag=tag)
        return out

    @staticmethod
    def backward(ctx, grad):
        dst, g, tag, pending = ctx.meta
        _isend(grad, dst, g, tag, pending)
        return None, None, None, None, None, None


class _PipeIn(torch.autograd.Function):
    """The schedule's pipe-invariant inputs: identity forward, the
    cotangents summed over the stages (one all-reduce) backward."""

    @staticmethod
    def forward(ctx, g, *xs):
        ctx.g = g
        ctx.shapes = [x.shape for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([gr.reshape(-1) for gr in grads])
        dist.all_reduce(flat, group=ctx.g)
        out, off = [], 0
        for shape in ctx.shapes:
            n = torch.Size(shape).numel()
            out.append(flat[off:off + n].view(shape))
            off += n
        return (None, *out)


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every stage.  The extra inputs (empty
    tokens of this stage's sends and inputs) tie the whole local schedule
    to the output, so that every stage runs its backward."""

    @staticmethod
    def forward(ctx, out, src, g, is_last, *tokens):
        ctx.is_last = is_last
        ctx.token_meta = [(t.dtype, t.device) for t in tokens]
        buf = out.detach().clone()
        dist.broadcast(buf, src=src, group=g)
        return buf

    @staticmethod
    def backward(ctx, grad):
        tokens = [torch.zeros(0, dtype=d, device=dev)
                  for d, dev in ctx.token_meta]
        return (grad if ctx.is_last else None, None, None, None, *tokens)


def _slice_microbatch(tree, idx: int, n_micro: int):
    """Microbatch ``idx`` of a batch-leading tree."""
    def f(a):
        mb = a.shape[0] // n_micro
        return a[idx * mb:(idx + 1) * mb]
    return tree_map(f, tree)


def _to_f32(tree):
    return tree_map(lambda a: a.float() if torch.is_floating_point(a)
                    else a, tree)


def pipeline_blocks(block_chunk: Callable[[torch.Tensor, Any],
                                          torch.Tensor],
                    x: torch.Tensor, mb_context: Any, *, mesh, n_micro: int,
                    axis: str = 'pipe') -> torch.Tensor:
    """Run the trunk over the ``pp`` stages of ``mesh``'s ``axis``.

    ``block_chunk(x_mb, ctx_mb) -> x_mb`` applies THIS rank's stage of
    blocks (JAX passes the stage's slice of the stacked weights; here the
    chunk holds its blocks).  ``x`` ``(B, ...)`` enters the first block;
    ``mb_context``: a tree of per-sample side inputs ``(B, ...)`` (the
    adaLN conditioning, the cross-attention context; None leaves allowed),
    sliced per microbatch in lockstep with ``x``.  ``B % n_micro == 0``;
    the bubble is ``(pp − 1)/(n_micro + pp − 1)`` of the ticks.  Returns
    the activations after all blocks on every stage, in ``x``'s dtype."""
    pp = axis_size(mesh, axis)
    if pp == 1:
        if n_micro == 1:
            return block_chunk(x, mb_context)
        return _pipeline_pp1(block_chunk, x, mb_context, n_micro)
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f'batch {B} is not divisible into {n_micro} '
                         f'microbatches')
    pending = _pending_sends(mesh)
    _finish_sends(pending)
    g = group(mesh, axis)
    stage = axis_index(mesh, axis)
    last = pp - 1
    out_dtype = x.dtype
    x = x.float()
    mb_context = _to_f32(mb_context)
    leaves = []
    tree_map(leaves.append, mb_context)
    ins = [x] + [a for a in leaves if torch.is_floating_point(a)]
    if torch.is_grad_enabled() and any(a.requires_grad for a in ins):
        outs = iter(_PipeIn.apply(g, *ins))
        x = next(outs)
        mb_context = tree_map(
            lambda a: next(outs) if torch.is_floating_point(a) else a,
            mb_context)
    anchor = x.new_zeros(0).requires_grad_(torch.is_grad_enabled())
    prev = dist.get_global_rank(g, stage - 1) if stage > 0 else None
    nxt = dist.get_global_rank(g, stage + 1) if stage < last else None
    mb = B // n_micro
    tokens = [x.reshape(-1)[:0]]
    outputs = []
    for m in range(n_micro):
        if stage == 0:
            inp = x[m * mb:(m + 1) * mb]
        else:
            inp = _Recv.apply(anchor, (mb,) + tuple(x.shape[1:]), prev, g, m,
                              pending)
        y = block_chunk(inp, _slice_microbatch(mb_context, m, n_micro))
        y = y.float()
        if stage == last:
            outputs.append(y)
        elif torch.is_grad_enabled() and y.requires_grad:
            tokens.append(_Send.apply(y, nxt, g, m, pending))
        else:
            _isend(y.detach(), nxt, g, m, pending)
    out = torch.cat(outputs) if stage == last else x.new_empty(x.shape)
    out = _FromLast.apply(out, dist.get_global_rank(g, last), g,
                          stage == last, *tokens)
    return out.to(out_dtype)


def _pipeline_pp1(block_chunk, x, mb_context, n_micro: int):
    """The pp = 1 schedule: a plain loop over the microbatches."""
    mb = x.shape[0] // n_micro
    ys = [block_chunk(x[i * mb:(i + 1) * mb] * 1.0,
                      _slice_microbatch(mb_context, i, n_micro))
          for i in range(n_micro)]
    return torch.cat(ys)


def split_stages(blocks, pp: int) -> list:
    """The trunk's blocks (a sequence of depth L) as ``pp`` stages of
    ``L/pp`` contiguous blocks."""
    L = len(blocks)
    if L % pp:
        raise ValueError(f'depth {L} is not divisible into {pp} stages')
    n = L // pp
    return [list(blocks)[s * n:(s + 1) * n] for s in range(pp)]


def dit_pipeline_apply(model, x, timesteps, context, *, mesh,
                       n_micro: int, axis: str = 'pipe',
                       remat: bool = False):
    """Pipeline-parallel forward of a ``DiT_TriLatent`` (JAX :171): the
    embed and the head run as usual on every stage, the trunk through
    :func:`pipeline_blocks` with this rank's stage of blocks.  ``remat``
    recomputes each block in the backward pass under the model's
    ``remat_policy``.  Equal to ``model(x, timesteps, context)``."""
    from ..models.dit import _remat_call

    pp = axis_size(mesh, axis)
    depth = len(model.blocks)
    if depth % pp:
        raise ValueError(f'depth {depth} is not divisible into {pp} stages')
    B, H, W, _ = x.shape
    tokens, t, c, crossattn, dino = model.embed(x, timesteps, context)
    stage_blocks = split_stages(model.blocks, pp)[axis_index(mesh, axis)]
    policy = model.cfg.remat_policy

    def block_chunk(xb, ctx):
        cb, ca, dn = ctx
        for block in stage_blocks:
            if remat:
                xb = _remat_call(policy, block, xb, cb, ca, dn)
            else:
                xb = block(xb, cb, context=ca, dino_tokens=dn)
        return xb

    tokens = pipeline_blocks(block_chunk, tokens, (c, crossattn, dino),
                             mesh=mesh, n_micro=n_micro, axis=axis)
    return model.head(tokens, t, (B, H, W))
