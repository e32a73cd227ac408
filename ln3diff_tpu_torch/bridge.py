"""JAX (Linen) parameter trees → torch ``state_dict``s.

The inverse of the per-layer rules of
``ln3diff_tpu/conditioning/convert.py:31-55``, for the modules of the
text→3D path.  Input: the JAX package's params as nested dicts of numpy
arrays (``variables['params']`` or the whole ``variables``).  The port's
modules keep the JAX modules' names, so each leaf maps by its path:

* Dense ``kernel (in, out)`` → Linear ``weight (out, in)`` (EqualDense too:
  its scaling stays a runtime scale, as in JAX);
* Conv ``kernel`` HWIO → OIHW, grouped convs included (Linen's
  ``(kh, kw, in/groups, out)`` becomes torch's ``(out, in/groups, kh, kw)``);
* LayerNorm / GroupNorm ``scale`` → ``weight``; Embed ``embedding`` →
  ``weight``; ``bias`` and free parameters keep their names;
* ``nn.scan``-stacked trunks (leading depth axis) → one module per block:
  ``blocks/block/…`` → ``blocks.{i}.…`` for ``DiT_TriLatent`` and
  ``dit2/blocks/{within,across}/…`` → ``dit2.blocks.{i}.{within,across}…``;
* CLIP's ``layers_{i}`` → ``layers.{i}``.

The DiT's sin-cos ``pos_embed`` lives in the ``constants`` collection;
the port recomputes it as a buffer, so it is not carried.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(path: tuple, arr: np.ndarray):
    name = path[-1]
    if name == 'kernel':
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f'{"/".join(path)}: kernel of rank {arr.ndim}')
        name = 'weight'
    elif name in ('scale', 'embedding'):
        name = 'weight'
    key = '.'.join(path[:-1] + (name,))
    return key, torch.from_numpy(np.array(arr, np.float32, order='C'))


def _convert(params: Mapping, stacked: dict) -> dict[str, torch.Tensor]:
    """``stacked`` maps a JAX path prefix (tuple) to the torch prefix of
    the per-block modules that its leading axis splits into."""
    if 'params' in params:
        params = params['params']
    out = {}
    for path, value in _flatten(params):
        arr = np.asarray(value, dtype=np.float32)
        for prefix, torch_prefix in stacked.items():
            if path[:len(prefix)] == prefix:
                rest = path[len(prefix):]
                for i in range(arr.shape[0]):
                    key, t = _leaf(rest, arr[i])
                    out[f'{torch_prefix}.{i}.{key}'] = t
                break
        else:
            key, t = _leaf(path, arr)
            out[key] = t
    return out


def dit_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``DiT_TriLatent`` (text variant) params → the port's state dict."""
    return _convert(params, {('blocks', 'block'): 'blocks'})


def vae_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Decode-side ``TriplaneVAE`` params (``ldm_upsample``, ``dit2``,
    ``conv_sr``, ``osg_decoder``) → the port's state dict.  Encoder-side
    params, if present, are left out."""
    if 'params' in params:
        params = params['params']
    keep = ('ldm_upsample', 'dit2', 'conv_sr', 'osg_decoder')
    params = {k: v for k, v in params.items() if k in keep}
    return _convert(params, {('dit2', 'blocks'): 'dit2.blocks'})


def clip_text_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``CLIPTextModel`` params → the port's state dict."""
    out = {}
    for key, t in _convert(params, {}).items():
        out[re.sub(r'^layers_(\d+)\.', r'layers.\1.', key)] = t
    return out
