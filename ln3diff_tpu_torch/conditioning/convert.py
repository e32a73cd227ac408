"""Reference torch state dicts → the JAX package's parameter layout.

Port of ``ln3diff_tpu/conditioning/convert.py``: the per-layer rules
(``linear``, ``conv2d``, ``layer_norm``, ``group_norm``, ``embedding``
:31-58), the Hugging Face tower converters (``convert_hf_clip_text`` :61,
``convert_hf_clip_vision`` :97, ``convert_hf_dinov2`` :132),
``load_torch_checkpoint`` :215 and ``split_joint_checkpoint`` :227.  The
output is the JAX layout — nested dicts of numpy arrays, Linen names,
HWIO convs, ``(in, out)`` dense kernels, scan-stacked blocks — leaf for
leaf the JAX function's, so that one converted ``.npz`` serves both
packages; ``bridge.py`` then maps it onto the port's modules.

Two departures, both at the file boundary:

* a bf16 tensor becomes f32 numpy (numpy has no bf16; the JAX package's
  ``_np`` raises on one — ``ROADMAP.md`` §3); f16 and f32 stay as they are;
* ``.safetensors`` files are read by :func:`load_safetensors`, a reader of
  the format written here (an 8-byte little-endian header length, a JSON
  header of ``dtype``/``shape``/``data_offsets``, the raw buffers), so
  that no ``safetensors`` package is needed.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def linear(sd: Mapping, prefix: str) -> dict:
    out = {'kernel': _np(sd[f'{prefix}.weight']).T}
    if f'{prefix}.bias' in sd:
        out['bias'] = _np(sd[f'{prefix}.bias'])
    return out


def conv2d(sd: Mapping, prefix: str) -> dict:
    # torch OIHW → HWIO
    out = {'kernel': _np(sd[f'{prefix}.weight']).transpose(2, 3, 1, 0)}
    if f'{prefix}.bias' in sd:
        out['bias'] = _np(sd[f'{prefix}.bias'])
    return out


def layer_norm(sd: Mapping, prefix: str) -> dict:
    return {'scale': _np(sd[f'{prefix}.weight']),
            'bias': _np(sd[f'{prefix}.bias'])}


def group_norm(sd: Mapping, prefix: str) -> dict:
    return layer_norm(sd, prefix)


def embedding(sd: Mapping, prefix: str) -> dict:
    return {'embedding': _np(sd[f'{prefix}.weight'])}


def _clip_layer(sd: Mapping, lp: str) -> dict:
    return {
        'layer_norm1': layer_norm(sd, f'{lp}.layer_norm1'),
        'layer_norm2': layer_norm(sd, f'{lp}.layer_norm2'),
        'self_attn': {
            'q_proj': linear(sd, f'{lp}.self_attn.q_proj'),
            'k_proj': linear(sd, f'{lp}.self_attn.k_proj'),
            'v_proj': linear(sd, f'{lp}.self_attn.v_proj'),
            'out_proj': linear(sd, f'{lp}.self_attn.out_proj'),
        },
        'mlp': {
            'fc1': linear(sd, f'{lp}.mlp.fc1'),
            'fc2': linear(sd, f'{lp}.mlp.fc2'),
        },
    }


def convert_hf_clip_text(state_dict: Mapping, num_layers: int = 12) -> dict:
    """HF ``CLIPTextModel.state_dict()`` → ``CLIPTextModel`` params."""
    sd = state_dict
    base = 'text_model.'
    if not any(k.startswith(base) for k in sd):
        base = ''
    params: dict = {
        'token_embedding': embedding(
            sd, f'{base}embeddings.token_embedding'),
        'position_embedding': _np(
            sd[f'{base}embeddings.position_embedding.weight']),
        'final_layer_norm': layer_norm(sd, f'{base}final_layer_norm'),
    }
    for i in range(num_layers):
        params[f'layers_{i}'] = _clip_layer(sd, f'{base}encoder.layers.{i}')
    # CLIPTextModelWithProjection / OpenAI encode_text head (bias-free)
    if 'text_projection.weight' in sd:
        params['text_projection'] = {
            'kernel': _np(sd['text_projection.weight']).T}
    return params


def convert_hf_clip_vision(state_dict: Mapping, num_layers: int = 24) -> dict:
    """HF ``CLIPVisionModel.state_dict()`` → ``CLIPVisionModel`` params."""
    sd = state_dict
    base = 'vision_model.'
    if not any(k.startswith(base) for k in sd):
        base = ''
    params: dict = {
        'patch_embedding': {
            'kernel': _np(sd[f'{base}embeddings.patch_embedding.weight'])
            .transpose(2, 3, 1, 0)},
        'class_embedding': _np(sd[f'{base}embeddings.class_embedding']),
        'position_embedding': _np(
            sd[f'{base}embeddings.position_embedding.weight']),
        'pre_layrnorm': layer_norm(sd, f'{base}pre_layrnorm'),
        'post_layernorm': layer_norm(sd, f'{base}post_layernorm'),
    }
    for i in range(num_layers):
        params[f'layers_{i}'] = _clip_layer(sd, f'{base}encoder.layers.{i}')
    return params


def convert_hf_dinov2(state_dict: Mapping, depth: int) -> dict:
    """HF ``Dinov2Model.state_dict()`` → the scan-stacked
    ``VisionTransformer`` params (DINOv2: layerscale, erf GELU): the
    per-layer tensors stack along a leading ``depth`` axis, and the
    query/key/value projections concatenate into one ``qkv``."""
    sd = state_dict
    base = 'dinov2.' if any(k.startswith('dinov2.') for k in sd) else ''
    lp = f'{base}encoder.layer.'

    def stack(fn):
        return np.stack([fn(i) for i in range(depth)])

    def leaf(name, transpose=False):
        def get(i):
            a = _np(sd[f'{lp}{i}.{name}'])
            return a.T if transpose else a
        return stack(get)

    def qkv(i, part):
        ap = f'{lp}{i}.attention.attention'
        if part == 'weight':
            return np.concatenate([_np(sd[f'{ap}.{n}.weight']).T
                                   for n in ('query', 'key', 'value')],
                                  axis=1)
        return np.concatenate([_np(sd[f'{ap}.{n}.bias'])
                               for n in ('query', 'key', 'value')], axis=0)

    block = {
        'norm1': {'scale': leaf('norm1.weight'), 'bias': leaf('norm1.bias')},
        'norm2': {'scale': leaf('norm2.weight'), 'bias': leaf('norm2.bias')},
        'gamma1': leaf('layer_scale1.lambda1'),
        'gamma2': leaf('layer_scale2.lambda1'),
        'attn': {
            'qkv': {'kernel': stack(lambda i: qkv(i, 'weight')),
                    'bias': stack(lambda i: qkv(i, 'bias'))},
            'proj': {'kernel': leaf('attention.output.dense.weight', True),
                     'bias': leaf('attention.output.dense.bias')},
        },
        'mlp': {
            'fc1': {'kernel': leaf('mlp.fc1.weight', True),
                    'bias': leaf('mlp.fc1.bias')},
            'fc2': {'kernel': leaf('mlp.fc2.weight', True),
                    'bias': leaf('mlp.fc2.bias')},
        },
    }
    return {
        'patch_embed': {
            'kernel': _np(sd[
                f'{base}embeddings.patch_embeddings.projection.weight'
            ]).transpose(2, 3, 1, 0),
            'bias': _np(sd[
                f'{base}embeddings.patch_embeddings.projection.bias'])},
        'cls_token': _np(sd[f'{base}embeddings.cls_token']),
        'pos_embed': _np(sd[f'{base}embeddings.position_embeddings']),
        'blocks': {'block': block},
        'norm': {'scale': _np(sd[f'{base}layernorm.weight']),
                 'bias': _np(sd[f'{base}layernorm.bias'])},
    }


# -- checkpoint files --------------------------------------------------------

_ST_DTYPES = {
    'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
    'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
    'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8,
    'BOOL': torch.bool,
}


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """A ``.safetensors`` file as ``{name: CPU tensor}``, bf16 and f16
    kept: the header (u64 little-endian length, then JSON) is parsed here
    and each tensor is viewed out of the file's bytes with
    ``torch.frombuffer``."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        dtype = _ST_DTYPES[info['dtype']]
        start, end = info['data_offsets']
        shape = tuple(info['shape'])
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        itemsize = torch.empty((), dtype=dtype).element_size()
        if start % itemsize:       # unaligned: copy the bytes out
            t = torch.frombuffer(bytearray(data[start:end]), dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype,
                                 count=(end - start) // itemsize,
                                 offset=start)
        out[name] = t.reshape(shape)
    return out


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pt`` / ``.safetensors`` state dict on the CPU (a ``.pt`` dict
    with a ``'state_dict'`` entry gives that entry)."""
    if path.endswith('.safetensors'):
        return load_safetensors(path)
    obj = torch.load(path, map_location='cpu', weights_only=False)
    if isinstance(obj, dict) and 'state_dict' in obj:
        return obj['state_dict']
    return obj


def split_joint_checkpoint(sd: Mapping) -> dict:
    """The reference's joint ``model_joint_denoise_rec_model`` dict split
    into submodule state dicts by the first name component
    (``ddpm_model.``, ``rec_model.``)."""
    out: dict[str, dict] = {}
    for k, v in sd.items():
        head, _, rest = k.partition('.')
        out.setdefault(head, {})[rest] = v
    return out
