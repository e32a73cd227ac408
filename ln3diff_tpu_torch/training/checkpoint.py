"""Checkpoint save and resume for the port's train states.

Port of ``ln3diff_tpu/training/checkpoint.py`` (``CheckpointManager`` :28,
``parse_resume_step_from_filename`` :63, ``save_numpy_checkpoint`` :70,
``load_numpy_checkpoint`` :81; reference ``guided_diffusion/
train_util.py:413-499``).  The manager is the counterpart of the orbax
one: one directory per step (``{directory}/{step}/state.pt``) holding the
parameters, every EMA copy, the AdamW moments and count and the step,
written to a temporary directory and renamed into place, and only the
newest ``max_to_keep`` steps kept.  The ``.npz`` helpers store a flat
dict of tensors under the port's state-dict names.

:func:`load_jax_tree_npz` reads the other ``.npz`` layout: a JAX param
tree flattened to slash-joined names, as the JAX package's
``save_numpy_checkpoint`` and both packages' convert CLIs write it.  It
unflattens the names, maps the tree through a ``bridge`` function and
loads it strictly into a port module.
"""

from __future__ import annotations

import os
import re
import shutil
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_STATE_FILE = 'state.pt'


def _cpu(tree):
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


class CheckpointManager:
    """Per-step checkpoint directories with the orbax manager's
    retention: ``save`` keeps the newest ``max_to_keep`` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, _STATE_FILE)))

    def save(self, step: int, state):
        """Write ``state`` (a ``train_state.TrainState``) as step
        ``step``, synchronously.  Under a process group every rank calls
        it: the whole state is assembled (``TrainState.payload``, sharded
        entries gathered), rank 0 writes, and the ranks meet after the
        write."""
        payload = _cpu(state.payload())
        rank = dist.get_rank() if dist.is_initialized() else 0
        if rank == 0:
            final = os.path.join(self.directory, str(int(step)))
            tmp = final + '.tmp'
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _STATE_FILE))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
        if dist.is_initialized():
            dist.barrier()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None):
        """Load step ``step`` (default: the latest) into ``state_like`` in
        place — the parameter tensors keep their identity, so the modules
        that own them see the restored values — and return it; None when
        there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        data = torch.load(os.path.join(self.directory, str(int(step)),
                                       _STATE_FILE), map_location='cpu',
                          weights_only=True)
        state_like.load_payload(data)
        return state_like

    def close(self):
        """The orbax manager's close: nothing is pending, since ``save``
        writes synchronously."""


def parse_resume_step_from_filename(filename: str) -> int:
    """The NNNNNNN of ``model_rec{NNNNNNN}.pt``-style names, else 0."""
    m = re.search(r'(\d{7})\.(pt|safetensors)$', filename)
    return int(m.group(1)) if m else 0


def save_numpy_checkpoint(path: str, params: Mapping):
    """A portable ``.npz`` of named tensors (a state dict)."""
    np.savez(path, **{k: v.detach().cpu().numpy()
                      for k, v in params.items()})


def load_numpy_checkpoint(path: str, params_like: Mapping) -> dict:
    """The tensors of ``path`` with the names, shapes, dtypes and devices
    of ``params_like``."""
    data = np.load(path)
    out = {}
    for k, like in params_like.items():
        arr = data[k]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f'{k}: shape {arr.shape} in {path}, '
                             f'{tuple(like.shape)} here')
        out[k] = torch.as_tensor(arr).to(dtype=like.dtype,
                                         device=like.device)
    return out


def flatten_jax_tree(tree: Mapping, prefix: str = '') -> dict:
    """A nested tree → ``{'a/b/c': leaf}`` in the JAX package's leaf order
    (keys sorted at every level, as ``jax.tree_util`` flattens dicts)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.update(flatten_jax_tree(v, f'{prefix}{k}/'))
        else:
            out[f'{prefix}{k}'] = v
    return out


def save_jax_tree_npz(path: str, tree: Mapping):
    """Write a nested tree of arrays as the JAX package's
    ``save_numpy_checkpoint`` does: slash-joined names, in its order."""
    np.savez(path, **{k: np.asarray(v)
                      for k, v in flatten_jax_tree(tree).items()})


def _unflatten_jax_tree(flat: Mapping) -> dict:
    """``{'a/b/c': array}`` → ``{'a': {'b': {'c': array}}}``."""
    tree: dict = {}
    for name, arr in flat.items():
        *parents, leaf = name.split('/')
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def load_state_dict_strict(module: torch.nn.Module, sd: Mapping,
                           what: str = '', keep=()) -> torch.nn.Module:
    """``module.load_state_dict(sd)`` that names the first offending key:
    a key of ``sd`` the module lacks, a tensor of the module ``sd`` lacks
    (except those listed in ``keep``, which keep their values) or a
    wrong shape raises."""
    own = module.state_dict()
    label = f'{what}: ' if what else ''
    extra = sorted(set(sd) - set(own))
    if extra:
        raise KeyError(f'{label}{extra[0]} is not a tensor of '
                       f'{type(module).__name__} ({len(extra)} extra keys)')
    missing = sorted(set(own) - set(sd) - set(keep))
    if missing:
        raise KeyError(f'{label}{missing[0]} of {type(module).__name__} is '
                       f'missing ({len(missing)} missing keys)')
    for k, t in sd.items():
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(f'{label}{k}: shape {tuple(t.shape)} in the '
                             f'checkpoint, {tuple(own[k].shape)} in '
                             f'{type(module).__name__}')
    module.load_state_dict(sd, strict=not keep)
    return module


def load_jax_tree_npz(path: str, module: torch.nn.Module, to_state_dict,
                      keep=()) -> torch.nn.Module:
    """Load a slash-joined JAX-tree ``.npz`` (a converted ``denoiser.npz``
    / ``vae.npz``, or a JAX ``save_numpy_checkpoint`` file) into
    ``module``: the tree goes through ``to_state_dict`` (a ``bridge``
    function such as ``dit_state_dict``), then
    :func:`load_state_dict_strict`."""
    with np.load(path) as data:
        tree = _unflatten_jax_tree({k: data[k] for k in data.files})
    return load_state_dict_strict(module, to_state_dict(tree), what=path,
                                  keep=keep)
