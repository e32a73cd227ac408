"""JAX (Linen) parameter trees → torch ``state_dict``s.

The inverse of the per-layer rules of
``ln3diff_tpu/conditioning/convert.py:31-55``, for the modules of the
text→3D, image→3D, multi-view→3D and ShapeNet/FFHQ text→3D paths.  Input: the JAX package's params as nested dicts of numpy
arrays (``variables['params']`` or the whole ``variables``).  The port's
modules keep the JAX modules' names, so each leaf maps by its path:

* Dense ``kernel (in, out)`` → Linear ``weight (out, in)`` (EqualDense too:
  its scaling stays a runtime scale, as in JAX); the multi-view
  attention's ``DenseGeneral``s (the ``'lgm'`` encoder) → Linear too: the
  ``qkv`` kernel ``(C, 3, heads, hd)`` flattened to ``(C, 3·heads·hd)``,
  the ``proj`` kernel ``(heads, hd, C)`` to ``(heads·hd, C)``;
* Conv ``kernel`` HWIO → OIHW, grouped convs included (Linen's
  ``(kh, kw, in/groups, out)`` becomes torch's ``(out, in/groups, kh, kw)``),
  and StyleGAN's raw modulated-conv ``weight`` (kh, kw, Cin, Cout) → (Cout,
  Cin, kh, kw);
* LayerNorm / GroupNorm / RMSNorm ``scale`` → ``weight``; Embed
  ``embedding`` → ``weight``; ``bias`` and free parameters (the DiT's
  ``scale_shift_table``s, the ViT's and the fusion blocks'
  ``gamma1``/``gamma2``, the fusion decoder's ``pos_embed``, the U-Net's
  ``mixing_logit``, StyleGAN's ``noise_const``/``noise_strength`` and
  the FFHQ VAE's ``sr_ws``) keep their names;
* a quantized denoiser's ``Int8Dense`` / ``Int8Conv`` (``ops/int8.py``):
  int8 ``kernel_q (in, out)`` → ``Int8Linear`` ``kernel_q (out, in)`` and
  ``kernel_q (kh, kw, in, out)`` → ``Int8Conv`` ``kernel_q (out, in, kh,
  kw)``, still int8; the sibling ``scale (out,)`` keeps its name and stays
  f32;
* ``nn.scan``-stacked trunks (leading depth axis) → one module per block:
  ``blocks/block/…`` → ``blocks.{i}.…`` for ``DiT_TriLatent`` and
  ``dit2/blocks/{within,across}/…`` → ``dit2.blocks.{i}.{within,across}…``
  and ``blocks/block/…`` → ``blocks.{i}.…`` for ``VisionTransformer``
  (``encoder/blocks/block/…`` in the ShapeNet/FFHQ VAEs);
* CLIP's ``layers_{i}`` → ``layers.{i}``.

The DiT's sin-cos ``pos_embed`` lives in the ``constants`` collection;
the port recomputes it as a buffer, so it is not carried.

Every map is linear (transposes, splits and renames only), so it also
carries a JAX grad tree (``jax.grad`` of a trainer's loss) onto the port's
parameter names: ``dit_state_dict`` for the LDM trainer (a
``learn_sigma`` head is a wider final ``linear``), ``vae_state_dict`` for
the VAE trainer, ``controlnet_state_dict`` for the ControlNet trainer,
``lsgm_state_dict`` for the LSGM trainer's joint tree and
``discriminator_state_dict`` / ``vision_aided_state_dict`` for the
adversarial heads.

Generators carry their ``'stats'`` collection too: ``w_avg`` of the
mapping and, in StyleGAN3, the Fourier ``freqs``/``phases``/``transform``
and each layer's ``magnitude_ema`` become the buffers of those names
(``eg3d_generator_state_dict``, ``sg3_generator_state_dict``); so do the
converters' ``_``-prefixed leaves (``mapping/_w_avg`` → ``mapping.w_avg``).

Reference checkpoints: :func:`reference_trees` runs the converters of
``conditioning/convert_ln3diff.py`` for each kind of the convert CLI
(``KINDS``) and :func:`reference_state_dicts` carries their trees onto
the port's modules.
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


def _leaf(path: tuple, arr: np.ndarray, int8_dense: bool = False):
    """One leaf → (torch key, tensor).  ``int8_dense``: the leaf's module
    is an ``Int8Dense`` (its ``scale`` is the weight scale, not a norm's)."""
    name = path[-1]
    if name == 'kernel_q':
        arr = np.asarray(arr, np.int8)
        arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        return '.'.join(path), torch.from_numpy(np.ascontiguousarray(arr))
    if name == 'kernel':
        if arr.ndim == 2:
            arr = arr.T
        elif arr.ndim == 3 or (arr.ndim == 4 and path[-2] == 'qkv'
                               and arr.shape[1] == 3
                               and arr.shape[0] == arr.shape[2]
                               * arr.shape[3]):
            # DenseGeneral: proj (heads, hd, C), qkv (C, 3, heads, hd)
            fan_in = arr.shape[0] * arr.shape[1] if arr.ndim == 3 \
                else arr.shape[0]
            arr = arr.reshape(fan_in, -1).T
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f'{"/".join(path)}: kernel of rank {arr.ndim}')
        name = 'weight'
    elif name == 'weight' and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif name == 'embedding' or (name == 'scale' and not int8_dense):
        name = 'weight'
    elif name.startswith('_'):          # a converter's 'stats' leaf
        name = name[1:]
    key = '.'.join(path[:-1] + (name,))
    return key, torch.from_numpy(np.array(arr, np.float32, order='C'))


def _convert(params: Mapping, stacked: dict) -> dict[str, torch.Tensor]:
    """``stacked`` maps a JAX path prefix (tuple) to the torch prefix of
    the per-block modules that its leading axis splits into."""
    if 'params' in params:
        params = params['params']
    leaves = list(_flatten(params))
    int8_modules = {path[:-1] for path, _ in leaves if path[-1] == 'kernel_q'}
    out = {}
    for path, value in leaves:
        int8 = path[:-1] in int8_modules
        arr = np.asarray(value)
        if path[-1] != 'kernel_q':
            arr = arr.astype(np.float32)
        for prefix, torch_prefix in stacked.items():
            if path[:len(prefix)] == prefix:
                rest = path[len(prefix):]
                for i in range(arr.shape[0]):
                    key, t = _leaf(rest, arr[i], int8)
                    out[f'{torch_prefix}.{i}.{key}'] = t
                break
        else:
            key, t = _leaf(path, arr, int8)
            out[key] = t
    return out


def dit_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``DiT_TriLatent`` params (every variant, quantized or not) → the
    port's state dict.
    ``VisionTransformer`` keeps its blocks in the same ``nn.scan`` layout,
    so ``vit_state_dict`` is this function."""
    return _convert(params, {('blocks', 'block'): 'blocks'})


vit_state_dict = dit_state_dict


def vae_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``TriplaneVAE``, ``ShapeNetVAE`` or ``FFHQVAE`` params → the port's
    state dict: the decode side, the SR head (and ``sr_ws``) and, when
    present, the encoder, ``ldm_downsample`` and ``quant_conv``.

    The map is linear (transposes and renames only), so it also carries a
    JAX grad tree onto the port's parameter names."""
    return _convert(params, {('dit2', 'blocks'): 'dit2.blocks',
                             ('encoder', 'blocks', 'block'): 'encoder.blocks'})


def unet_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``UNetModel`` params (``mixing_logit`` included, quantized or not)
    → the port's state dict.  ``ControlNet`` (its U-Net blocks, zero convs
    and hint encoder keep the JAX names) and ``ConfNet`` map the same way:
    ``controlnet_state_dict`` and ``confnet_state_dict`` are this
    function."""
    return _convert(params, {})


controlnet_state_dict = confnet_state_dict = unet_state_dict


def lsgm_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """The LSGM trainer's joint ``{'vae': ..., 'ddpm': ...}`` tree (its
    params, EMA or grads) → the names of ``LSGMTrainer.joint``:
    ``vae.*`` through ``vae_state_dict`` and ``ddpm.*`` through
    ``unet_state_dict``."""
    out = {f'vae.{k}': v for k, v in vae_state_dict(params['vae']).items()}
    out.update({f'ddpm.{k}': v
                for k, v in unet_state_dict(params['ddpm']).items()})
    return out


def clip_text_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``CLIPTextModel`` params → the port's state dict."""
    out = {}
    for key, t in _convert(params, {}).items():
        out[re.sub(r'^layers_(\d+)\.', r'layers.\1.', key)] = t
    return out


# CLIPVisionModel's layers are named as the text tower's
clip_vision_state_dict = clip_text_state_dict

# the adversarial trainer's networks keep the JAX names: the StyleGAN and
# dual discriminators (``d.*``) and LPIPS (``vgg.conv{i}``, the heads
# ``lin{i}`` in their (1, 1, 1, C) shape) map leaf by leaf
discriminator_state_dict = lpips_state_dict = unet_state_dict


def eg3d_generator_state_dict(variables: Mapping
                              ) -> dict[str, torch.Tensor]:
    """A generator's variables (``TriPlaneGenerator``, ``GeneratorSG3`` or
    a bare ``MappingNetwork``) → the port's state dict: the params leaf by
    leaf and every leaf of the 'stats' collection as the buffer of its
    path (``mapping.w_avg``; StyleGAN3's ``synthesis.input.freqs`` …,
    ``synthesis.L0_36_512.magnitude_ema`` …)."""
    out = _convert(variables['params'], {})
    for path, v in _flatten(variables.get('stats', {})):
        out['.'.join(path)] = torch.from_numpy(np.array(v, np.float32))
    return out


sg3_generator_state_dict = mapping_state_dict = eg3d_generator_state_dict


def vision_aided_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """``VisionAidedDiscriminator`` params → the port's state dict: the
    CLIP backbone through ``clip_vision_state_dict``, the level heads,
    ``cls_fc`` and ``head_cls`` leaf by leaf."""
    if 'params' in params:
        params = params['params']
    out = {f'backbone.{k}': v for k, v in
           clip_vision_state_dict(params['backbone']).items()}
    out.update(_convert({k: v for k, v in params.items()
                         if k != 'backbone'}, {}))
    return out



_BN_LEAVES = {'bn_scale': 'bn.weight', 'bn_bias': 'bn.bias',
              'bn_mean': 'bn.running_mean', 'bn_var': 'bn.running_var'}


def inception_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """The FID ``InceptionV3`` params of
    ``ln3diff_tpu/evaluation/inception.py`` → the port's (pytorch-fid)
    names: each ``conv`` kernel HWIO → OIHW, ``bn_scale`` / ``bn_bias`` /
    ``bn_mean`` / ``bn_var`` → ``bn.weight`` / ``bn.bias`` /
    ``bn.running_mean`` / ``bn.running_var``, ``fc`` as a Linear."""
    out = {}
    for key, t in _convert(params, {}).items():
        head, _, leaf = key.rpartition('.')
        if leaf in _BN_LEAVES:
            key = '.'.join(filter(None, (head, _BN_LEAVES[leaf])))
        out[key] = t
    return out

# -- reference checkpoints ---------------------------------------------------

# the kinds of the convert CLI (``scripts/convert_checkpoint.py:30-31``)
KINDS = ('joint-objaverse', 'joint-shapenet', 'vae-objaverse',
         'vae-shapenet', 'vae-ffhq')


def reference_trees(kind: str, sd: Mapping, dit_depth: int = 24,
                    dit2_depth: int = 24, denoiser_variant: str = 'text',
                    fusion_depth: int = 6, encoder_depth: int = 12,
                    unet_cfg=None) -> dict:
    """A reference state dict of ``kind`` → the JAX package's trees,
    ``{'denoiser': ..., 'vae': ..., 'mixing_logit': ...}`` (the entries
    the kind holds), as ``scripts/convert_checkpoint.py`` ``convert``
    builds them.  ``unet_cfg``: the U-Net of ``joint-shapenet`` (default
    ``denoiser_preset('shapenet-unet')``)."""
    from .conditioning import convert_ln3diff as C
    if kind == 'joint-objaverse':
        return C.convert_joint_objaverse(
            sd, dit_depth=dit_depth, dit2_depth=dit2_depth,
            denoiser_variant=denoiser_variant)
    if kind == 'joint-shapenet':
        if unet_cfg is None:
            from .config import denoiser_preset
            unet_cfg = denoiser_preset('shapenet-unet')
        return C.convert_joint_shapenet(sd, unet_cfg=unet_cfg,
                                        fusion_depth=fusion_depth,
                                        encoder_depth=encoder_depth)
    if kind == 'vae-objaverse':
        return {'vae': C.convert_vae_objaverse(sd, dit2_depth=dit2_depth)}
    if kind == 'vae-shapenet':
        return {'vae': C.convert_vae_shapenet(sd, fusion_depth=fusion_depth,
                                              encoder_depth=encoder_depth)}
    if kind == 'vae-ffhq':
        return {'vae': C.convert_vae_ffhq(sd, fusion_depth=fusion_depth,
                                          encoder_depth=encoder_depth)}
    raise ValueError(f'unknown kind {kind!r} (choices: {KINDS})')


def trees_state_dicts(kind: str, trees: Mapping) -> dict:
    """:func:`reference_trees`' output → the port's state dicts: the
    denoiser through ``unet_state_dict`` (``joint-shapenet``) or
    ``dit_state_dict``, the VAE through ``vae_state_dict`` and the DiT
    checkpoints' ``mixing_logit`` as an f32 tensor."""
    out = {}
    if 'denoiser' in trees:
        to_sd = unet_state_dict if kind == 'joint-shapenet' \
            else dit_state_dict
        out['denoiser'] = to_sd(trees['denoiser'])
    if 'vae' in trees:
        out['vae'] = vae_state_dict(trees['vae'])
    if 'mixing_logit' in trees:
        out['mixing_logit'] = torch.tensor(
            np.asarray(trees['mixing_logit'], np.float32))
    return out


def reference_state_dicts(kind: str, sd: Mapping, **depths) -> dict:
    """A reference state dict of one of ``KINDS`` → ``{'denoiser': state
    dict, 'vae': state dict, 'mixing_logit': tensor}`` (the entries the
    kind holds) under the port's names, every leaf f32.  ``depths``:
    :func:`reference_trees`' depths, variant and ``unet_cfg``."""
    return trees_state_dicts(kind, reference_trees(kind, sd, **depths))
