"""Device mesh, process groups and the parameter placement rules.

Port of ``ln3diff_tpu/parallel/mesh.py`` to ``torch.distributed``: one
process per device under ``torchrun``, a ``DeviceMesh`` of shape (data,
pipe, fsdp, tensor) — JAX's axis order (:52-53) — and its process groups.
Where XLA inserts the collectives of a pjit'd step, the port's steps call
them (``training/train_state.py``, ``parallel/pipeline.py``,
``parallel/serving.py``).

Axes:
  * ``data``  — batch sharding;
  * ``fsdp``  — the batch as well, and with it the parameters the rules
                shard: each rank's module holds 1/fsdp of each, gathered
                where the forward reads it, its grad reduce-scattered
                (``parallel/fsdp.py``), and 1/fsdp of its AdamW moments
                and EMA (``DTensor`` ``Shard`` placements,
                ``TrainState``);
  * ``tensor``— tensor-parallel serving of the denoiser
                (``serving.tp_shard_denoiser_params``); in training the
                tensor ranks compute as data replicas and shard the
                optimizer state of the parameters the rules split;
  * ``pipe``  — the DiT trunk's blocks split into contiguous stages
                (``parallel/pipeline.py``); a rank holds its own stage's
                blocks only.

Without a process group (one process, no ``torchrun``) :func:`make_mesh`
gives a :class:`LocalMesh` of size 1 and every collective is skipped.

Placements: the rules return ``{parameter name: placements}`` with one
placement per mesh axis, in the mesh's order: ``Replicate()``,
``Shard(dim)`` of the port's tensor, or, on the pipe axis,
:class:`LayerShard` (the trunk's layer axis, which the port keeps as a
``ModuleList``).  They choose the same logical axis as JAX's rules: a
torch ``Linear.weight`` is ``(out, in)`` where a Linen kernel is ``(in,
out)``, a conv weight ``(out, in, kh, kw)`` where Linen's is ``(kh, kw,
in, out)``, and the blocks JAX stacks with ``nn.scan`` (``…blocks.{i}.…``)
count with their leading layer axis in sizes and axis order.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.tensor import Replicate, Shard

AXES = ('data', 'pipe', 'fsdp', 'tensor')
# the batch axes: JAX's P(('data', 'fsdp'))
DP_AXES = ('data', 'fsdp')


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1       # -1 → all remaining ranks
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1


class LocalMesh:
    """The mesh of a process without a process group: every axis of size
    1, no collective."""
    mesh_dim_names = AXES
    shape = (1, 1, 1, 1)

    def __init__(self, device_type: str = 'cpu'):
        self.device_type = device_type

    def size(self, dim: Optional[int] = None) -> int:
        return 1


def _default_device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == 'nccl':
        return 'cuda'
    return 'cpu'


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: Optional[str] =
              None):
    """A ``DeviceMesh`` of shape (data, pipe, fsdp, tensor) over the world
    (``data = -1`` takes the ranks the other axes leave); a
    :class:`LocalMesh` when no process group is initialised and the world
    is one process.  ``device_type`` defaults to the process group's:
    ``'cuda'`` under NCCL, else ``'cpu'``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    model = cfg.fsdp * cfg.tensor * cfg.pipe
    data = cfg.data if cfg.data > 0 else world // model
    if data * model != world:
        raise ValueError(f'mesh {data}x{cfg.pipe}x{cfg.fsdp}x{cfg.tensor} '
                         f'!= {world} ranks')
    device_type = device_type or _default_device_type()
    if not dist.is_initialized():
        return LocalMesh(device_type)
    from torch.distributed.device_mesh import init_device_mesh
    # pipe outermost after data, as in JAX: tp/fsdp innermost
    return init_device_mesh(device_type, (data, cfg.pipe, cfg.fsdp,
                                          cfg.tensor), mesh_dim_names=AXES)


def is_distributed(mesh) -> bool:
    """True when ``mesh`` has process groups (collectives run, at any
    size)."""
    return mesh is not None and not isinstance(mesh, LocalMesh)


def axis_size(mesh, *names: str) -> int:
    """The product of the sizes of the axes ``names`` (1 without a
    mesh)."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape[AXES.index(n)] for n in names)


def axis_index(mesh, *names: str) -> int:
    """This rank's position along the axes ``names`` flattened in mesh
    order (JAX's order of ``P(('data', 'fsdp'))``)."""
    if not is_distributed(mesh):
        return 0
    coord = mesh.get_coordinate()
    index = 0
    for n in names:
        i = AXES.index(n)
        index = index * mesh.shape[i] + coord[i]
    return index


def group(mesh, *names: str):
    """The process group of this rank over the axes ``names`` (ranks in
    :func:`axis_index` order), or None without process groups.  A group
    over several axes is made once per mesh (every rank makes every such
    group, in the same order) and kept on the mesh."""
    if not is_distributed(mesh):
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    groups = mesh.__dict__.setdefault('_flat_groups', {})
    if names not in groups:
        ranks = mesh.mesh
        keep = [AXES.index(n) for n in names]
        rest = [i for i in range(len(AXES)) if i not in keep]
        ranks = ranks.permute(*rest, *keep).reshape(
            -1, math.prod(ranks.shape[i] for i in keep))
        groups[names], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[names]


# ---------------------------------------------------------------------------
# batch trees: a rank's slice and the gather back
# ---------------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples (None stays None)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, '_fields'):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _is_array(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, np.ndarray)


def data_sharding(mesh, tree, axis: int = 0):
    """This rank's slice of a global batch tree over the (data, fsdp)
    ranks: every array leaf with more than ``axis`` dims is cut into equal
    contiguous parts along ``axis`` (JAX's ``P(('data', 'fsdp'))`` on axis
    0, or on axis 1 under grad accumulation); lower-rank leaves (the
    KL-anneal ``step``) and non-arrays pass through whole."""
    n = axis_size(mesh, *DP_AXES)
    if n == 1:
        return tree
    r = axis_index(mesh, *DP_AXES)

    def cut(x):
        if not _is_array(x) or x.ndim <= axis:
            return x
        if x.shape[axis] % n:
            raise ValueError(f'batch axis of size {x.shape[axis]} is not '
                             f'divisible by the {n} (data, fsdp) ranks')
        k = x.shape[axis] // n
        if torch.is_tensor(x):
            return x.narrow(axis, r * k, k)
        return np.take(x, np.arange(r * k, (r + 1) * k), axis=axis)

    return tree_map(cut, tree)


def replicated(mesh, tree, axis: int = 0):
    """The inverse of :func:`data_sharding` for tensor leaves: every
    rank's slice gathered over the (data, fsdp) ranks and concatenated
    along ``axis`` in global order."""
    if not is_distributed(mesh):
        return tree
    g = group(mesh, *DP_AXES)
    n = axis_size(mesh, *DP_AXES)

    def gather(x):
        if not torch.is_tensor(x) or x.ndim <= axis:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=g)
        return torch.cat(parts, dim=axis)

    return tree_map(gather, tree)


def all_reduce_mean(mesh, tensors: list, names=DP_AXES) -> None:
    """Average a list of tensors in place over the ranks of ``names``:
    one all-reduce of a flat buffer per dtype."""
    if not is_distributed(mesh) or not tensors:
        return
    g = group(mesh, *names)
    n = axis_size(mesh, *names)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=g)
        flat /= n
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------

class LayerShard:
    """The pipe axis's placement of a trunk block's parameter: sharded
    over the trunk's layer axis, so block ``i`` of ``depth`` lives on
    stage ``i // (depth / pp)`` (:func:`stage_of`)."""

    def __eq__(self, other):
        return isinstance(other, LayerShard)

    def __hash__(self):
        return hash('LayerShard')

    def __repr__(self):
        return 'LayerShard()'


def stage_of(block_index: int, depth: int, pp: int) -> int:
    return block_index // (depth // pp)


def trunk_index(name: str, trunk_key: str = 'blocks'):
    """(trunk prefix, block index) of a parameter of a
    ``…{trunk_key}.{i}.…`` block, else None."""
    segs = name.split('.')
    for j in range(len(segs) - 1):
        if segs[j] == trunk_key and segs[j + 1].isdigit():
            return '.'.join(segs[:j + 1]), int(segs[j + 1])
    return None


def _logical_params(module: nn.Module, trunk_key: str = 'blocks',
                    int8: bool = False):
    """``(name, owner path segments, is_kernel, jax_shape, port_axis)``
    per parameter: JAX's shape of the leaf (with the stacked layer axis
    first for a trunk block) and, per JAX axis, the port tensor's axis
    (None for the layer axis).  ``int8``: the int8 layers' ``kernel_q``
    buffers too, which are parameters in JAX."""
    modules = dict(module.named_modules())
    params = list(module.named_parameters())
    if int8:
        params += [(n, b) for n, b in module.named_buffers()
                   if n.rsplit('.', 1)[-1] == 'kernel_q']
    depth: dict = {}
    for name, _ in params:
        hit = trunk_index(name, trunk_key)
        if hit is not None:
            depth[hit[0]] = max(depth.get(hit[0], 0), hit[1] + 1)
    for name, p in params:
        owner_name, leaf = name.rsplit('.', 1) if '.' in name \
            else ('', name)
        owner = modules.get(owner_name)
        linear = isinstance(owner, nn.Linear) or (
            leaf == 'kernel_q' and p.ndim == 2) or (
            type(owner).__name__.endswith('Linear') and leaf == 'weight')
        is_kernel = (leaf == 'kernel_q') or (leaf == 'weight' and (
            linear or isinstance(owner, nn.modules.conv._ConvNd)))
        shape = tuple(p.shape)
        if p.ndim == 2 and linear:
            jmap = [1, 0]                       # (in, out)
        elif p.ndim == 4 and leaf in ('weight', 'kernel_q'):
            jmap = [2, 3, 1, 0]                 # (kh, kw, in, out)
        else:
            jmap = list(range(p.ndim))
        jshape = [shape[a] for a in jmap]
        hit = trunk_index(name, trunk_key)
        if hit is not None:
            jshape = [depth[hit[0]]] + jshape
            jmap = [None] + jmap
        yield name, owner_name.split('.'), is_kernel, jshape, jmap


def _replicate():
    return [Replicate() for _ in AXES]


def param_sharding_rules(module: nn.Module, mesh,
                         min_size_to_shard: int = 2**18) -> dict:
    """FSDP placements (JAX :65): a parameter of at least
    ``min_size_to_shard`` elements is sharded over 'fsdp' along its
    largest axis that the fsdp size divides (ties to JAX's earlier axis);
    the rest stay replicated, as does a trunk parameter whose chosen axis
    is JAX's stacked layer axis."""
    fsdp = axis_size(mesh, 'fsdp')
    out = {}
    for name, _, _, jshape, jmap in _logical_params(module):
        pl = _replicate()
        if fsdp > 1 and math.prod(jshape) >= min_size_to_shard:
            order = sorted(range(len(jshape)), key=lambda i: -jshape[i])
            for ax in order:
                if jshape[ax] % fsdp == 0:
                    if jmap[ax] is not None:
                        pl[AXES.index('fsdp')] = Shard(jmap[ax])
                    break
        out[name] = tuple(pl)
    return out


COL_MARKERS = ('qkv', 'fc1', 'to_q', 'to_k', 'to_v', 'q_proj', 'k_proj',
               'v_proj', 'ff_proj', 'proj_in')
ROW_MARKERS = ('proj', 'fc2', 'to_out', 'out_proj', 'mlp_img', 'ff_out',
               'proj_out')


def tensor_parallel_rules(module: nn.Module, mesh,
                          min_size_to_shard: int = 2**16) -> dict:
    """Tensor-parallel placements (JAX :89): a kernel of at least
    ``min_size_to_shard`` elements under an exact path segment of
    ``COL_MARKERS`` is column-parallel — its output axis over 'tensor'
    (``Shard(0)`` of a Linear weight) — and under ``ROW_MARKERS``
    row-parallel — its input axis (``Shard(1)``); with fsdp > 1 the other
    axis of the pair goes over 'fsdp' when divisible.  An int8 layer's
    ``kernel_q`` buffer is placed as a kernel, as JAX places the int8
    ``kernel_q`` leaf.  Biases and every other parameter stay replicated,
    as in JAX."""
    tp = axis_size(mesh, 'tensor')
    fsdp = axis_size(mesh, 'fsdp')
    t_i, f_i = AXES.index('tensor'), AXES.index('fsdp')
    out = {}
    for name, segs, is_kernel, jshape, jmap in _logical_params(module,
                                                               int8=True):
        pl = _replicate()
        out[name] = tuple(pl)
        if tp == 1 or math.prod(jshape) < min_size_to_shard \
                or len(jshape) < 2 or not is_kernel:
            continue
        segs = set(segs)
        if segs & set(COL_MARKERS) and jshape[-1] % tp == 0:
            pl[t_i] = Shard(jmap[-1])
            if fsdp > 1 and jshape[-2] % fsdp == 0:
                pl[f_i] = Shard(jmap[-2])
        elif segs & set(ROW_MARKERS) and jshape[-2] % tp == 0:
            pl[t_i] = Shard(jmap[-2])
            if fsdp > 1 and jshape[-1] % fsdp == 0:
                pl[f_i] = Shard(jmap[-1])
        out[name] = tuple(pl)
    return out


def pipeline_parallel_rules(module: nn.Module, mesh,
                            trunk_key: str = 'blocks',
                            base: Optional[dict] = None) -> dict:
    """Pipeline placements (JAX :145): a trunk block's parameters get
    :class:`LayerShard` on the pipe axis when the pipe size divides the
    depth; every other entry keeps ``base``'s placements (default
    replicated)."""
    pp = axis_size(mesh, 'pipe')
    out = {}
    for name, _, _, jshape, jmap in _logical_params(module, trunk_key):
        pl = list(base[name]) if base is not None else _replicate()
        if pp > 1 and jmap and jmap[0] is None and jshape[0] % pp == 0:
            pl[AXES.index('pipe')] = LayerShard()
        out[name] = tuple(pl)
    return out


def training_placements(module: nn.Module, mesh,
                        pipeline: bool = False) -> Optional[dict]:
    """The placements a trainer gives ``TrainState.create``:
    :func:`param_sharding_rules` when the fsdp axis is above 1, and with
    ``pipeline`` the trunk's :func:`pipeline_parallel_rules` on top; None
    when neither applies."""
    base = param_sharding_rules(module, mesh) \
        if axis_size(mesh, 'fsdp') > 1 else None
    if pipeline:
        return pipeline_parallel_rules(module, mesh, base=base)
    return base


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def host_shard() -> tuple:
    """``(rank, world size)`` of this process (JAX :175)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_rng(seed: int) -> np.random.Generator:
    """The per-rank host RNG (JAX :186): ``default_rng([seed, rank])``
    for host-side draws (patch origins, cameras, resampled timesteps), so
    that ranks never crop the same windows.  Device-side draws stay global
    (the steps take their rank's slice)."""
    return np.random.default_rng([int(seed), host_shard()[0]])


def initialize_distributed(device='cuda') -> bool:
    """Join the process group that ``torchrun`` describes (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR`` in the environment): NCCL for a CUDA
    ``device`` — whose index becomes ``LOCAL_RANK`` — and gloo for the
    CPU.  Without that environment, or when already joined, a no-op.
    Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if not all(k in env for k in ('WORLD_SIZE', 'RANK', 'MASTER_ADDR')):
        return False
    device = torch.device(device)
    if device.type == 'cuda':
        from ..pipeline import resolve_device
        resolve_device(device)
        torch.cuda.set_device(int(env.get('LOCAL_RANK', 0)))
        dist.init_process_group('nccl')
    else:
        dist.init_process_group('gloo')
    return True
