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
"""

from __future__ import annotations

import os
import re
import shutil
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

_STATE_FILE = 'state.pt'


def _cpu(tree):
    if isinstance(tree, Mapping):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def _copy_into(dst: Mapping, src: Mapping, what: str):
    if sorted(dst) != sorted(src):
        raise ValueError(f'{what}: the checkpoint holds other tensors '
                         f'({sorted(set(src) ^ set(dst))[:4]} ...)')
    with torch.no_grad():
        for k, t in dst.items():
            if t.shape != src[k].shape:
                raise ValueError(f'{what}.{k}: shape {tuple(src[k].shape)} '
                                 f'in the checkpoint, {tuple(t.shape)} here')
            t.copy_(src[k])


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
        ``step``, synchronously."""
        payload = dict(params=_cpu(state.params), ema=_cpu(state.ema_params),
                       opt=_cpu(state.opt_state), step=int(state.step))
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
        _copy_into(state_like.params, data['params'], 'params')
        if sorted(state_like.ema_params) != sorted(data['ema']):
            raise ValueError('the checkpoint holds other EMA rates')
        for name, ema in state_like.ema_params.items():
            _copy_into(ema, data['ema'][name], f'ema.{name}')
        for part in ('mu', 'nu'):
            _copy_into(state_like.opt_state[part], data['opt'][part], part)
        state_like.opt_state = dict(state_like.opt_state,
                                    count=int(data['opt']['count']))
        state_like.step = int(data['step'])
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
