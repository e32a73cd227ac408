"""Optimizer, EMA and the training step's gradient plumbing.

Port of ``ln3diff_tpu/training/train_state.py``: ``make_optimizer`` :65
(optax's ``chain(clip_by_global_norm, adamw)`` with per-module learning
rates and the warmup-cosine schedule), the EMA of ``apply_gradients``
:38-52, the frozen ``constants`` of the train state and the generic step
``build_train_step`` :107-195 (microbatch gradient averaging, the
``per_sample*`` metrics flattened in draw order; under a mesh the batch
and the draws cut per rank, the grads averaged over the (data, fsdp)
ranks, the parameters that the FSDP rules shard held in the module as
their shards, :class:`TrainState`), and
``frozen_apply``, a module run on detached parameters (the frozen prior
of the LSGM q term, the discriminator in a generator term).
Written out with optax's arithmetic rather than taken from ``torch.optim``,
so that one step matches the JAX trainer's:

* the global norm clip scales by ``max / ‖g‖`` only when ``‖g‖ ≥ max``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
* AdamW: ``mu = b1·mu + (1 − b1)·g``, ``nu = b2·nu + (1 − b2)·g²``,
  bias-corrected with the incremented count, ``u = mû / (√nû + eps)``,
  decoupled weight decay ``u + wd·p``, then ``p − lr·u`` with the
  learning rate of the count before the increment;
* learning-rate groups by top-level module name.

Parameters stay f32; the optimizer updates them in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call


def warmup_cosine(base_lr: float, warmup_steps: int = 0,
                  total_steps: Optional[int] = None):
    """The learning rate per step of ``make_optimizer``: constant
    ``base_lr``, or with a warmup or a total the schedule
    ``optax.warmup_cosine_decay_schedule(0, base_lr, warmup or 1,
    (total or 1e9) − warmup, end_value=0.1·base_lr)`` (whose cosine spans
    its decay steps less the warmup)."""
    if not (warmup_steps or total_steps):
        return lambda count: base_lr
    warmup = warmup_steps or 1
    decay = (total_steps or 10**9) - (warmup_steps or 0) - warmup
    if decay <= 0:
        raise ValueError('the cosine part of the schedule needs positive '
                         'length')
    alpha = 0.1

    def schedule(count):
        if count < warmup:
            frac = 1.0 - min(max(count, 0), warmup) / warmup
            return (0.0 - base_lr) * frac + base_lr
        c = min(count - warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
        return base_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """√(Σ ‖t‖²) over a list of tensors, in f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))`` over a
    dict of named parameters (see the module docstring).  ``lr_groups``
    maps a top-level module name (the part of a parameter name before the
    first dot) to its own base learning rate."""
    lr: float
    weight_decay: float = 0.01
    betas: tuple = (0.9, 0.999)
    eps: float = 1e-8
    grad_clip: Optional[float] = 0.5
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    lr_groups: Optional[dict] = None

    def group_of(self, name: str) -> str:
        top = name.split('.', 1)[0]
        return top if self.lr_groups and top in self.lr_groups else ''

    def init(self, params: dict) -> dict:
        return dict(count=0,
                    mu={k: torch.zeros_like(p) for k, p in params.items()},
                    nu={k: torch.zeros_like(p) for k, p in params.items()})

    def learning_rate(self, group: str, count: int) -> float:
        base = self.lr_groups[group] if group else self.lr
        return warmup_cosine(base, self.warmup_steps,
                             self.total_steps)(count)

    @torch.no_grad()
    def clip(self, grads: dict, g_norm: Optional[torch.Tensor] = None
             ) -> dict:
        """The grads after ``clip_by_global_norm`` (``g_norm``: their
        global norm when the caller has it, say across ranks)."""
        if not self.grad_clip:
            return grads
        if g_norm is None:
            g_norm = global_norm(list(grads.values()))
        if float(g_norm) < self.grad_clip:
            return grads
        return {k: (g / g_norm.to(g.dtype)) * self.grad_clip
                for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> dict:
        """Update ``params`` in place from ``grads`` (already clipped by
        :meth:`clip`), and the moments of ``state`` in place; returns the
        new state."""
        b1, b2 = self.betas
        count = state['count'] + 1
        # optax takes decay**count in f32
        bc1 = float(np.float32(1) - np.float32(b1)**np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2)**np.float32(count))
        groups = {}
        for k in params:
            groups.setdefault(self.group_of(k), []).append(k)
        for group, keys in groups.items():
            ps = [params[k] for k in keys]
            gs = [grads[k].to(params[k].dtype) for k in keys]
            mus = [state['mu'][k] for k in keys]
            nus = [state['nu'][k] for k in keys]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(gs, gs), 1 - b2))
            mu_hat = torch._foreach_div(mus, bc1)
            nu_hat = torch._foreach_div(nus, bc2)
            denom = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu_hat, denom)
            if self.weight_decay:
                torch._foreach_add_(upd, torch._foreach_mul(
                    ps, self.weight_decay))
            lr = self.learning_rate(group, state['count'])
            torch._foreach_add_(ps, torch._foreach_mul(upd, -lr))
        return dict(state, count=count)


def make_optimizer(lr: float, weight_decay: float = 0.01,
                   betas=(0.9, 0.999), grad_clip: Optional[float] = 0.5,
                   warmup_steps: int = 0, total_steps: Optional[int] = None,
                   lr_groups: Optional[dict] = None) -> AdamW:
    """AdamW with the global-norm clip (the reference clips at 0.5,
    ``fp16_util.py:241``) and the optional warmup and anneal; the
    arguments of the JAX function."""
    return AdamW(lr=lr, weight_decay=weight_decay, betas=tuple(betas),
                 grad_clip=grad_clip, warmup_steps=warmup_steps,
                 total_steps=total_steps, lr_groups=dict(lr_groups or {}))


@torch.no_grad()
def update_ema(ema: dict, params: dict, rate: float):
    """``e·rate + p·(1 − rate)`` in place, from the updated params."""
    keys = list(ema)
    es = [ema[k] for k in keys]
    torch._foreach_mul_(es, rate)
    torch._foreach_add_(es, torch._foreach_mul(
        [params[k].to(ema[k].dtype) for k in keys], 1 - rate))


@dataclasses.dataclass
class TrainState:
    """The module's trainable parameters (by name), the optimizer and its
    state, one EMA copy per rate, the step count and the ``constants``
    that the loss reads and no optimizer touches (a frozen network, say).

    Under a mesh (:meth:`create` with ``placements``):

    * a parameter whose placements shard it over 'fsdp' lives in the
      module as its rank's shard (``parallel.fsdp.ShardedParams``:
      gathered where the forward reads it, its grad reduce-scattered);
      ``params`` holds it as a ``DTensor`` over the (fsdp, tensor) ranks
      on the module's own storage, and its AdamW moments and EMA are
      sharded alike;
    * a parameter sharded over 'tensor' only keeps its whole tensor in
      the module (the tensor ranks compute as a data replica): its
      optimizer state, EMA and the slice it updates are sharded, and the
      module tensor is gathered from the slices after each update
      (``refresh``);
    * a trunk block that another pipeline stage owns (``LayerShard``)
      leaves this rank: its parameters and buffers move to the ``meta``
      device, and ``absent`` keeps its parameters' (owning stage, shape,
      dtype) for :meth:`payload` and :meth:`load_payload`."""
    params: dict
    tx: AdamW
    opt_state: dict
    ema_params: dict
    ema_rates: tuple = ()
    step: int = 0
    constants: Any = None
    mesh: Any = None
    module: Any = None
    sharded: Any = None
    refresh: tuple = ()
    absent: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def create(cls, module: torch.nn.Module, tx: AdamW,
               ema_rates: tuple = (), constants=None, mesh=None,
               placements: Optional[dict] = None) -> 'TrainState':
        from ..parallel.mesh import (AXES, LayerShard, axis_index,
                                     axis_size, is_distributed, stage_of,
                                     trunk_index)
        named = {k: p for k, p in module.named_parameters()
                 if p.requires_grad}
        absent, dims, layouts = {}, {}, {}
        if placements:
            from torch.distributed.tensor import Shard
            pp = axis_size(mesh, 'pipe')
            me = axis_index(mesh, 'pipe')
            depth: dict = {}
            for k in named:
                hit = trunk_index(k)
                if hit is not None:
                    depth[hit[0]] = max(depth.get(hit[0], 0), hit[1] + 1)
            gone = set()
            for k in list(named):
                pl = placements.get(k)
                if pl is None:
                    continue
                if isinstance(pl[AXES.index('pipe')], LayerShard):
                    prefix, i = trunk_index(k)
                    owner = stage_of(i, depth[prefix], pp)
                    if owner != me:
                        p = named.pop(k)
                        absent[k] = (owner, tuple(p.shape), p.dtype)
                        gone.add(f'{prefix}.{i}')
                        continue
                fs = [pl[AXES.index('fsdp')], pl[AXES.index('tensor')]]
                if any(isinstance(f, Shard) for f in fs) \
                        and is_distributed(mesh):
                    layouts[k] = fs
                    if isinstance(fs[0], Shard):
                        dims[k] = fs[0].dim
            for name in sorted(gone):
                module.get_submodule(name).to('meta')
        sharded = None
        if dims:
            from ..parallel.fsdp import ShardedParams
            sharded = ShardedParams(module, mesh, dims)
        params, refresh = dict(named), []
        if layouts:
            from torch.distributed.tensor import DTensor
            sub = mesh['fsdp', 'tensor']
            for k, fs in layouts.items():
                p = named[k].detach()
                if fs[1].is_shard():
                    p = _local_slice(p, None, fs, sub,
                                     skip=(0,) if k in dims else ())
                    p = p.clone()
                    refresh.append(k)
                with torch.no_grad():
                    params[k] = DTensor.from_local(p, sub, fs,
                                                   run_check=False)
        ema = {name: {k: p.detach().clone() for k, p in params.items()}
               for name, _ in ema_rates}
        return cls(params=params, tx=tx, opt_state=tx.init(params),
                   ema_params=ema, ema_rates=tuple(ema_rates),
                   constants=constants, mesh=mesh, module=module,
                   sharded=sharded, refresh=tuple(refresh), absent=absent)

    def module_params(self) -> dict:
        """The module's parameters that this rank trains, by name (a
        sharded one as its shard)."""
        named = dict(self.module.named_parameters())
        return {k: named[k] for k in self.params}

    def forward_scope(self):
        """The context of the training step's forward: with sharded
        parameters autograd keeps recipes, not whole tensors, for the
        backward (``ShardedParams.saving``)."""
        if self.sharded is None:
            return contextlib.nullcontext()
        return self.sharded.saving()

    def reduce_grads(self, grads: dict):
        """Average the local grads over the batch ranks in place, as
        pjit's psum does: a sharded parameter's grad (already summed over
        the fsdp ranks by the reduce-scatter) over 'data' and divided by
        the fsdp size, every other grad over (data, fsdp)."""
        from ..parallel.mesh import DP_AXES, all_reduce_mean, axis_size
        dims = self.sharded.dims if self.sharded is not None else {}
        all_reduce_mean(self.mesh, [g for k, g in grads.items()
                                    if k not in dims], DP_AXES)
        mine = [g for k, g in grads.items() if k in dims]
        if mine:
            all_reduce_mean(self.mesh, mine, ('data',))
            torch._foreach_div_(mine, float(axis_size(self.mesh, 'fsdp')))

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The norm of the whole model's grads from this rank's local
        ones: the squares of the sharded grads summed over the fsdp
        ranks, those of the trunk blocks over the pipeline stages (with
        one fsdp rank and no stages, the plain norm of the grads)."""
        if not (self.absent or (self.sharded and self.sharded.n > 1)):
            return global_norm(list(grads.values()))
        from ..parallel.mesh import group, trunk_index
        dims = self.sharded.dims if self.sharded is not None else {}
        buckets: dict = {}
        for k, g in grads.items():
            axes = (('pipe',) if self.absent and trunk_index(k) else ()) \
                + (('fsdp',) if k in dims else ())
            buckets.setdefault(axes, []).append(g)
        keys = [()]
        if self.absent:
            keys.append(('pipe',))
        if dims:
            keys += [('fsdp',)] + ([('pipe', 'fsdp')] if self.absent else [])
        device = next(iter(grads.values())).device
        total = torch.zeros((), device=device)
        for axes in keys:
            gs = buckets.get(axes)
            sq = global_norm(gs)**2 if gs else torch.zeros((), device=device)
            if axes:
                dist.all_reduce(sq, group=group(self.mesh, *axes))
            total = total + sq
        return torch.sqrt(total)

    def apply_gradients(self, grads: dict,
                        g_norm: Optional[torch.Tensor] = None):
        """One optimizer step, then the EMA of the new params.  ``grads``
        are the module's (every rank's average; a sharded parameter's is
        its shard's; ``g_norm`` their global norm when the caller has it);
        each update reads the slice of the grad that its parameter
        holds."""
        grads = self.tx.clip(grads, g_norm)
        local = {k: _local(p) for k, p in self.params.items()}
        grads = {k: self._update_slice(k, g) for k, g in grads.items()}
        opt = dict(self.opt_state,
                   mu={k: _local(v) for k, v in self.opt_state['mu'].items()},
                   nu={k: _local(v) for k, v in self.opt_state['nu'].items()})
        count = self.tx.step(local, grads, opt)['count']
        self.opt_state = dict(self.opt_state, count=count)
        for name, rate in self.ema_rates:
            update_ema({k: _local(v) for k, v in
                        self.ema_params[name].items()}, local, rate)
        self._refresh()
        self.step += 1

    def _update_slice(self, k: str, t: torch.Tensor) -> torch.Tensor:
        """The part of a module-sized tensor ``t`` that ``params[k]``
        holds on this rank."""
        like = self.params[k]
        if not _is_dtensor(like):
            return t
        dims = self.sharded.dims if self.sharded is not None else {}
        return _local_slice(t, like, skip=(0,) if k in dims else ())

    def _refresh(self):
        """The module tensors of the tensor-sharded parameters from their
        updated slices."""
        if self.refresh:
            self.load_module({k: self.params[k].full_tensor()
                              for k in self.refresh})

    @torch.no_grad()
    def load_module(self, whole: dict):
        """Copy whole tensors (by name) into the module's parameters, each
        sharded one as this rank's shard."""
        named = dict(self.module.named_parameters())
        dims = self.sharded.dims if self.sharded is not None else {}
        for k, w in whole.items():
            w = w.to(named[k].device)
            if k in dims:
                w = w.chunk(self.sharded.n, dims[k])[self.sharded.rank]
            named[k].copy_(w)

    # -- whole state, for checkpoints ---------------------------------------

    def payload(self) -> dict:
        """The whole state as plain tensors on every rank (a collective
        under a mesh): sharded entries gathered, the blocks of other
        pipeline stages received from their owners."""
        def whole(d):
            return {k: (v.full_tensor() if _is_dtensor(v) else v)
                    for k, v in d.items()}

        params = whole(self.params)
        mu, nu = whole(self.opt_state['mu']), whole(self.opt_state['nu'])
        ema = {n: whole(e) for n, e in self.ema_params.items()}
        if self.absent:
            from ..parallel.mesh import (axis_index, group, stage_of,
                                         trunk_index)
            g = group(self.mesh, 'pipe')
            me = axis_index(self.mesh, 'pipe')
            device = next(iter(params.values())).device
            names = sorted(set(params) | set(self.absent),
                           key=lambda k: (trunk_index(k) is None, k))
            for k in names:
                if k not in self.absent and trunk_index(k) is None:
                    continue
                if k in self.absent:
                    owner, shape, dtype = self.absent[k]
                else:
                    owner, shape, dtype = me, params[k].shape, params[k].dtype
                src = dist.get_global_rank(g, owner)
                for d in (params, mu, nu, *ema.values()):
                    buf = d[k].detach().contiguous() if k in d \
                        else torch.empty(shape, dtype=dtype, device=device)
                    dist.broadcast(buf, src=src, group=g)
                    d[k] = buf
        return dict(params=params, ema=ema,
                    opt=dict(mu=mu, nu=nu, count=self.opt_state['count']),
                    step=int(self.step))

    @torch.no_grad()
    def load_payload(self, data: dict):
        """Set the state from a :meth:`payload` (on the CPU): each rank
        takes its slice of a sharded entry and skips other stages'
        blocks."""
        def load(dst, src, what):
            missing = sorted(set(dst) - set(src))
            extra = sorted(set(src) - set(dst) - set(self.absent))
            if missing or extra:
                raise ValueError(f'{what}: the checkpoint holds other tensors'
                                 f' ({(missing + extra)[:4]} ...)')
            for k, t in dst.items():
                v = src[k]
                if tuple(v.shape) != tuple(t.shape):
                    raise ValueError(f'{what}.{k}: shape {tuple(v.shape)} in '
                                     f'the checkpoint, {tuple(t.shape)} here')
                if _is_dtensor(t):
                    _local(t).copy_(_local_slice(v.to(t.device), t))
                else:
                    t.copy_(v)

        load(self.params, data['params'], 'params')
        if sorted(self.ema_params) != sorted(data['ema']):
            raise ValueError('the checkpoint holds other EMA rates')
        for name, e in self.ema_params.items():
            load(e, data['ema'][name], f'ema.{name}')
        for part in ('mu', 'nu'):
            load(self.opt_state[part], data['opt'][part], part)
        self.opt_state = dict(self.opt_state,
                              count=int(data['opt']['count']))
        self.step = int(data['step'])
        self.load_module({k: data['params'][k] for k in self.refresh})


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _local(t):
    """The rank's own tensor of a ``DTensor`` (its storage), else ``t``."""
    return t.to_local() if _is_dtensor(t) else t


def _local_slice(full: torch.Tensor, like, placements=None, mesh=None,
                 skip: tuple = ()):
    """This rank's shard of the whole tensor ``full`` in the layout of the
    ``DTensor`` ``like`` (or of ``placements`` over ``mesh``: evenly
    divided ``Shard``/``Replicate``), leaving out the mesh dims in
    ``skip`` (already cut); else ``full``."""
    if like is not None:
        if not _is_dtensor(like):
            return full
        mesh, placements = like.device_mesh, like.placements
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard() and i not in skip:
            full = full.chunk(mesh.size(i), pl.dim)[coord[i]]
    return full


def frozen_apply(model: torch.nn.Module, *args):
    """``model(*args)`` with its parameters detached: grads reach the
    inputs, not the parameters."""
    from ..parallel.fsdp import sharded_params_of
    sharded = sharded_params_of(model)
    held = set() if sharded is None else {id(p) for p in
                                          sharded.params.values()}
    params = {k: v.detach() for k, v in model.named_parameters()
              if id(v) not in held}
    if sharded is None:
        return functional_call(model, params, args)
    # the sharded ones are gathered detached
    with sharded.frozen():
        return functional_call(model, params, args)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def build_train_step(loss_fn: Callable, microbatch_steps: int = 1,
                     mesh=None, draw_fn: Optional[Callable] = None):
    """The training step of ``loss_fn(params, constants, batch, draws) ->
    (loss, metrics)`` (JAX ``build_train_step``'s ``step_fn``).

    The returned ``step_fn(state, batch, draws=None) -> metrics`` runs the
    loss and its backward pass, then the clip, AdamW and the EMA
    (``TrainState.apply_gradients``).  With ``microbatch_steps`` S > 1,
    every batch leaf of rank ≥ 2 (nested dicts included) is split along
    its leading S axis and leaves of lower rank go to every microbatch
    unchanged; ``draws`` is then a sequence of S draws (or None), the
    grads are summed and divided by S and the metrics averaged, except the
    ``per_sample*`` ones, which are concatenated in draw order.  The
    metrics hold ``loss`` and ``grad_norm`` (of the unclipped grads).

    ``batch`` and ``draws`` are global.  Without draws, ``draw_fn(micro
    batch)`` makes them (else ``loss_fn`` draws its own).  Under a
    ``mesh`` each rank runs the loss on its (data, fsdp) slice of the
    batch — axis 0, or axis 1 under grad accumulation, as JAX shards it —
    and of the draws (axis 0), and the grads are averaged over those ranks
    before the clip, as pjit's inserted all-reduce does (a sharded
    parameter's through its reduce-scatter, :meth:`TrainState.reduce_grads`);
    ``loss`` and the
    mean metrics are averaged over them too, and ``per_sample*`` entries
    gathered in global order."""
    from ..parallel.mesh import (DP_AXES, all_reduce_mean, data_sharding,
                                 replicated)
    steps = microbatch_steps

    def step_fn(state: TrainState, batch, draws=None) -> dict:
        if steps > 1 and draws is not None and len(draws) != steps:
            raise ValueError(f'{len(draws)} draws for {steps} microbatches')
        params = state.module_params()
        for p in params.values():
            p.grad = None
        local = data_sharding(mesh, batch, axis=0 if steps == 1 else 1)
        losses, metrics = [], {}
        for i in range(steps):
            micro = local if steps == 1 else _tree_map(
                lambda v: v[i] if np.ndim(v) >= 2 else v, local)
            d = draws if steps == 1 or draws is None else draws[i]
            if d is None and draw_fn is not None:
                d = draw_fn(batch if steps == 1 else _tree_map(
                    lambda v: v[i] if np.ndim(v) >= 2 else v, batch))
            d = data_sharding(mesh, d)
            with state.forward_scope():
                loss, terms = loss_fn(params, state.constants, micro, d)
            loss.backward()
            losses.append(loss.detach())
            for k, v in terms.items():
                v = v.detach()
                metrics.setdefault(k, []).append(
                    replicated(mesh, v) if k.startswith('per_sample') else v)
        grads = {k: (torch.zeros_like(p) if p.grad is None
                     else p.grad / steps) for k, p in params.items()}
        for p in params.values():
            p.grad = None
        state.reduce_grads(grads)
        gnorm = state.global_norm(grads)
        state.apply_gradients(grads, gnorm)
        out = {k: (torch.cat(v) if k.startswith('per_sample')
                   else torch.stack(v).float().mean())
               for k, v in metrics.items()}
        out['loss'] = torch.stack(losses).float().mean()
        means = [k for k in out if not k.startswith('per_sample')]
        vals = torch.stack([out[k] for k in means])
        all_reduce_mean(mesh, [vals], DP_AXES)
        out.update(zip(means, vals.unbind()))
        out['grad_norm'] = gnorm
        return out

    return step_fn
