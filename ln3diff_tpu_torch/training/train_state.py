"""Optimizer, EMA and the training step's gradient plumbing.

Port of ``ln3diff_tpu/training/train_state.py``: ``make_optimizer`` :65
(optax's ``chain(clip_by_global_norm, adamw)`` with per-module learning
rates and the warmup-cosine schedule), the EMA of ``apply_gradients``
:38-52, the frozen ``constants`` of the train state and the generic step
``build_train_step`` :107-195 on one device (microbatch gradient
averaging, the ``per_sample*`` metrics flattened in draw order), and
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

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
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
    def clip(self, grads: dict) -> dict:
        """The grads after ``clip_by_global_norm``."""
        if not self.grad_clip:
            return grads
        g_norm = global_norm(list(grads.values()))
        if float(g_norm) < self.grad_clip:
            return grads
        return {k: (g / g_norm.to(g.dtype)) * self.grad_clip
                for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> dict:
        """Update ``params`` in place from ``grads``; returns the new
        state."""
        grads = self.clip(grads)
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
    that the loss reads and no optimizer touches (a frozen network, say)."""
    params: dict
    tx: AdamW
    opt_state: dict
    ema_params: dict
    ema_rates: tuple = ()
    step: int = 0
    constants: Any = None

    @classmethod
    def create(cls, module: torch.nn.Module, tx: AdamW,
               ema_rates: tuple = (), constants=None) -> 'TrainState':
        params = {k: p for k, p in module.named_parameters()
                  if p.requires_grad}
        ema = {name: {k: p.detach().clone() for k, p in params.items()}
               for name, _ in ema_rates}
        return cls(params=params, tx=tx, opt_state=tx.init(params),
                   ema_params=ema, ema_rates=tuple(ema_rates),
                   constants=constants)

    def apply_gradients(self, grads: dict):
        """One optimizer step, then the EMA of the new params."""
        self.opt_state = self.tx.step(self.params, grads, self.opt_state)
        for name, rate in self.ema_rates:
            update_ema(self.ema_params[name], self.params, rate)
        self.step += 1


def frozen_apply(model: torch.nn.Module, *args):
    """``model(*args)`` with its parameters detached: grads reach the
    inputs, not the parameters."""
    params = {k: v.detach() for k, v in model.named_parameters()}
    return functional_call(model, params, args)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def build_train_step(loss_fn: Callable, microbatch_steps: int = 1):
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
    metrics hold ``loss`` and ``grad_norm`` (of the unclipped grads)."""
    steps = microbatch_steps

    def step_fn(state: TrainState, batch, draws=None) -> dict:
        if steps > 1 and draws is not None and len(draws) != steps:
            raise ValueError(f'{len(draws)} draws for {steps} microbatches')
        params = state.params
        for p in params.values():
            p.grad = None
        losses, metrics = [], {}
        for i in range(steps):
            micro = batch if steps == 1 else _tree_map(
                lambda v: v[i] if np.ndim(v) >= 2 else v, batch)
            d = draws if steps == 1 or draws is None else draws[i]
            loss, terms = loss_fn(params, state.constants, micro, d)
            loss.backward()
            losses.append(loss.detach())
            for k, v in terms.items():
                metrics.setdefault(k, []).append(v.detach())
        grads = {k: (torch.zeros_like(p) if p.grad is None
                     else p.grad / steps) for k, p in params.items()}
        for p in params.values():
            p.grad = None
        gnorm = global_norm(list(grads.values()))
        state.apply_gradients(grads)
        out = {k: (torch.cat(v) if k.startswith('per_sample')
                   else torch.stack(v).float().mean())
               for k, v in metrics.items()}
        out.update(loss=torch.stack(losses).float().mean(), grad_norm=gnorm)
        return out

    return step_fn
