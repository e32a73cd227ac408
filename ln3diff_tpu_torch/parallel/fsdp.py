"""Parameters held inside the module as their shards over the 'fsdp' axis.

Under pjit a parameter that ``param_sharding_rules`` shards exists on a
device only as its shard; XLA gathers it where the computation reads it
and reduce-scatters its grad.  :class:`ShardedParams` does the same for a
torch module:

* each sharded parameter's storage is its rank's chunk along the rule's
  dim (``Shard(dim)`` over the fsdp ranks), so ``named_parameters()``
  yields the shards and the optimizer updates them in place;
* reading the attribute (``linear.weight``) returns the whole tensor,
  gathered over the fsdp ranks by :class:`_Gather`, whose backward
  reduce-scatters the grad into the shard's ``.grad`` (summed over the
  fsdp ranks);
* a unit is a trunk block (``…blocks.{i}``): its sharded parameters are
  gathered together by a forward pre-hook and dropped by the forward
  hook.  Every other parameter belongs to the root and is gathered where
  it is read, and dropped when that read's result is;
* while :meth:`saving` is active (the training step's forward), autograd
  keeps no whole tensor for the backward: a saved tensor that is a
  gathered parameter, a view of one, or its cast under autocast is
  packed as a recipe and gathered again when the backward unpacks it.
  A block under non-reentrant checkpointing saves nothing at all; its
  recomputation gathers again through the pre-hook.

So a rank holds a whole sharded parameter only during the forward of the
unit that reads it and the backward node that needs it.  The collectives
run in the same order on every fsdp rank: each runs the same module on
its own slice of the batch.  gloo has no reduce-scatter; on it the
backward all-reduces and keeps its chunk.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import axis_index, axis_size, group, trunk_index

_CLASSES: dict = {}


def _sharded_class(cls, leaves: tuple):
    """A subclass of ``cls`` (same name) whose ``leaves`` read as the
    whole tensors of the module's :class:`ShardedParams`."""
    key = (cls, leaves)
    if key not in _CLASSES:
        def prop(leaf):
            return property(lambda self: self.__dict__['_fsdp'].whole(
                self, leaf))
        _CLASSES[key] = type(cls.__name__, (cls,),
                             {leaf: prop(leaf) for leaf in leaves})
    return _CLASSES[key]


def _all_gather(shard: torch.Tensor, dim: int, g, n: int) -> torch.Tensor:
    parts = [torch.empty_like(shard) for _ in range(n)]
    dist.all_gather(parts, shard.contiguous(), group=g)
    return torch.cat(parts, dim)


def _reduce_scatter(whole: torch.Tensor, dim: int, g, n: int, r: int
                    ) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``whole`` over the
    ranks of ``g``."""
    if dist.get_backend(g) == 'gloo':
        whole = whole.contiguous().clone()
        dist.all_reduce(whole, group=g)
        return whole.chunk(n, dim)[r].contiguous()
    moved = whole.movedim(dim, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n,) + moved.shape[1:])
    dist.reduce_scatter_tensor(out, moved, group=g)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """The whole parameter from its shards; the backward reduce-scatters
    the grad (summed over the fsdp ranks)."""

    @staticmethod
    def forward(ctx, shard, dim, g, n, r):
        ctx.args = (dim, g, n, r)
        return _all_gather(shard, dim, g, n)

    @staticmethod
    def backward(ctx, grad):
        dim, g, n, r = ctx.args
        return _reduce_scatter(grad, dim, g, n, r), None, None, None, None


class _Whole:
    """A saved tensor packed as a recipe: parameter ``key`` gathered anew,
    cast to ``dtype`` when not None, then viewed as
    (size, stride, offset)."""
    __slots__ = ('key', 'dtype', 'size', 'stride', 'offset')

    def __init__(self, key, dtype, t):
        self.key, self.dtype = key, dtype
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


class ShardedParams:
    """The parameters of ``module`` named in ``dims`` (name → the dim of
    the port tensor that ``Shard`` cuts), sharded in place over the fsdp
    ranks of ``mesh`` (see the module docstring)."""

    def __init__(self, module: nn.Module, mesh, dims: dict):
        self.dims = dict(dims)
        self.group = group(mesh, 'fsdp')
        self.n = axis_size(mesh, 'fsdp')
        self.rank = axis_index(mesh, 'fsdp')
        self.params: dict = {}        # name → the module's Parameter
        self._key: dict = {}          # (id(owner), leaf) → name
        self._unit_of: dict = {}      # name → unit module or None (root)
        self._open: dict = {}         # id(unit) → {name: whole}
        self._live: dict = {}         # storage address → name
        self._nodes = weakref.WeakKeyDictionary()   # grad_fn → name
        self._regathered: dict = {}   # (name, dtype) → weakref of whole
        self._frozen = False
        modules = dict(module.named_modules())
        leaves: dict = {}
        units: dict = {}
        for name, dim in self.dims.items():
            owner_name, leaf = name.rsplit('.', 1) if '.' in name \
                else ('', name)
            owner = modules[owner_name]
            if owner.__dict__.get('_fsdp') not in (None, self):
                raise ValueError(f'{name}: the module is already sharded')
            p = owner._parameters[leaf]
            if p.shape[dim] % self.n:
                raise ValueError(f'{name}: dim {dim} of {tuple(p.shape)} '
                                 f'is not divisible by fsdp {self.n}')
            with torch.no_grad():
                p.data = p.data.chunk(self.n, dim)[self.rank].clone()
            self.params[name] = p
            self._key[(id(owner), leaf)] = name
            leaves.setdefault(owner_name, []).append(leaf)
            hit = trunk_index(name)
            unit = modules[f'{hit[0]}.{hit[1]}'] if hit else None
            self._unit_of[name] = unit
            if unit is not None:
                units.setdefault(id(unit), (unit, []))[1].append(name)
        for owner_name, ls in leaves.items():
            owner = modules[owner_name]
            object.__setattr__(owner, '_fsdp', self)
            owner.__class__ = _sharded_class(type(owner), tuple(sorted(ls)))
        for unit, names in units.values():
            unit.register_forward_pre_hook(
                lambda m, args, names=tuple(names): self._enter(m, names))
            unit.register_forward_hook(lambda m, args, out: self._exit(m),
                                       always_call=True)

    # -- gathering ----------------------------------------------------------

    def _gather(self, name: str) -> torch.Tensor:
        p = self.params[name]
        dim = self.dims[name]
        if self._frozen or not (torch.is_grad_enabled() and p.requires_grad):
            return _all_gather(p.detach(), dim, self.group, self.n)
        whole = _Gather.apply(p, dim, self.group, self.n, self.rank)
        ptr = whole.untyped_storage().data_ptr()
        self._live[ptr] = name
        weakref.finalize(whole, self._live.pop, ptr, None)
        self._nodes[whole.grad_fn] = name
        return whole

    def _enter(self, unit, names):
        self._open[id(unit)] = {k: self._gather(k) for k in names}

    def _exit(self, unit):
        self._open.pop(id(unit), None)

    def whole(self, owner, leaf: str) -> torch.Tensor:
        """The whole tensor of ``owner.leaf``: the open unit's, else
        gathered now."""
        name = self._key[(id(owner), leaf)]
        unit = self._unit_of[name]
        if unit is not None and id(unit) in self._open:
            return self._open[id(unit)][name]
        return self._gather(name)

    def units_whole(self) -> int:
        """How many units have whole parameters alive right now (the root
        counts as one when any of its gathered tensors is alive)."""
        live = set(self._live.values())
        return (len(self._open)
                + any(self._unit_of[k] is None for k in live)
                + len({id(self._unit_of[k]) for k in live
                       if self._unit_of[k] is not None
                       and id(self._unit_of[k]) not in self._open}))

    @contextlib.contextmanager
    def frozen(self):
        """Gather detached tensors: grads reach the inputs only."""
        prev, self._frozen = self._frozen, True
        try:
            yield
        finally:
            self._frozen = prev

    # -- autograd's saved tensors --------------------------------------------

    def _pack(self, t):
        base = t if t._base is None else t._base
        name = self._live.get(base.untyped_storage().data_ptr())
        if name is not None:
            return _Whole(name, None, t)
        fn = base.grad_fn
        if fn is not None and fn.name() == 'ToCopyBackward0':
            src = fn.next_functions[0][0]
            name = self._nodes.get(src) \
                if isinstance(src, _Gather._backward_cls) else None
            if name is not None:
                return _Whole(name, base.dtype, t)
        return t

    def _unpack(self, x):
        if not isinstance(x, _Whole):
            return x
        ref = self._regathered.get((x.key, x.dtype))
        whole = ref() if ref is not None else None
        if whole is None:
            p = self.params[x.key]
            whole = _all_gather(p.detach(), self.dims[x.key], self.group,
                                self.n)
            if x.dtype is not None:
                whole = whole.to(x.dtype)
            self._regathered[(x.key, x.dtype)] = weakref.ref(whole)
        return whole.as_strided(x.size, x.stride, x.offset)

    def saving(self):
        """Autograd saves recipes, not whole tensors (module docstring)."""
        self._regathered.clear()
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)


def sharded_params_of(module: nn.Module) -> Optional[ShardedParams]:
    """The :class:`ShardedParams` that holds some of ``module``'s
    parameters, or None."""
    for m in module.modules():
        mgr = m.__dict__.get('_fsdp')
        if mgr is not None:
            return mgr
    return None
