"""Reference-named state dicts for the checkpoint converters, written by
hand from the converters' key names (no reference code is needed).

Each ``*_reference`` function is the inverse of one converter composed
with the bridge: it takes a state dict under the port's names — drawn
from a port module by :func:`port_state_dict`, so that depth and widths
follow the module's config — and returns the same tensors under the
reference's names and in its layouts (HF CLIP and DINOv2, hub DINOv2,
the SD encoder and decoder, DiT and DiT2, the ADM U-Net's
``input_blocks``/``output_blocks`` enumeration, the fusion decoders,
StyleGAN2/3, EG3D, LPIPS).  Feeding the result to a converter and the
bridge gives the port's state dict back; feeding it to the JAX
package's converter gives JAX's tree.  Imports torch and numpy only:
``chip_smoke.py`` writes its full-width joint checkpoint with it.
"""

from __future__ import annotations

import re

import torch

__all__ = [
    'port_state_dict', 'dit_reference', 'dit2_reference',
    'vae_objaverse_reference', 'vae_shapenet_reference', 'vae_ffhq_reference',
    'unet_reference', 'eg3d_reference', 'sg3_synthesis_reference',
    'clip_text_reference', 'clip_vision_reference', 'dinov2_hf_reference',
    'dinov2_hub_reference', 'lpips_reference', 'joint_objaverse_reference',
    'joint_shapenet_reference', 'write_persistence_pickle']


def port_state_dict(module: torch.nn.Module, seed: int) -> dict:
    """The state dict of ``module`` after a seeded ``random_init_`` draw,
    as contiguous f32 CPU tensors (int8 and other dtypes kept), with the
    caption embedders' ``y_embedding`` zeroed: the reference has no such
    table, and the converters fill it with zeros."""
    from ln3diff_tpu_torch.models.layers import random_init_
    dev = next(module.parameters()).device
    random_init_(module, torch.Generator(device=dev).manual_seed(seed))
    out = {}
    for k, v in module.state_dict().items():
        v = v.detach().to('cpu', memory_format=torch.contiguous_format)
        if v.is_floating_point():
            v = v.float()
        out[k] = torch.zeros_like(v) if k.endswith('y_embedding') \
            else v.clone()
    return out


def _apply(key: str, rules) -> str:
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


def _map(sd: dict, groups, prefix: str = '') -> dict:
    """``groups``: (port prefix, reference prefix, rules); the first group
    whose prefix starts a key renames its rest with the rules (regex,
    replacement) in order.  A rest renamed to '' is dropped."""
    out = {}
    for k, v in sd.items():
        for pp, rp, rules in groups:
            if k.startswith(pp):
                rest = _apply(k[len(pp):], rules)
                if rest or not k[len(pp):]:
                    out[prefix + rp + rest] = v
                break
        else:
            raise KeyError(f'no reference name for {k}')
    return out


# -- DiT / DiT2 --------------------------------------------------------------

_DIT_BLOCK = [
    (r'\.mlp\.fc(\d)\.', lambda m: f'.mlp.mlp.{2 * int(m[1]) - 2}.'),
    (r'adaLN_modulation\.(weight|bias)$', r'adaLN_modulation.1.\1'),
    (r'\.to_out\.', '.to_out.0.'),
]
_DIT = [
    (r'^t_embedder\.fc(\d)\.',
     lambda m: f't_embedder.mlp.{2 * int(m[1]) - 2}.'),
    (r'^(clip_text_proj|dino_proj)\.fc(\d)\.', r'\1.y_proj.fc\2.'),
    (r'^(clip_text_proj|dino_proj)\.y_embedding$', ''),
    (r'^cap_norm\.', 'cap_embedder.0.'),
    (r'^cap_proj\.', 'cap_embedder.1.'),
] + _DIT_BLOCK


def dit_reference(sd: dict, prefix: str = '') -> dict:
    """``DiT_TriLatent`` (every variant) → reference ``DiT_TriLatent`` /
    PixArt names (``t_embedder.mlp.{0,2}``, ``blocks.{i}.mlp.mlp.{0,2}``,
    ``adaLN_modulation.1``, ``to_out.0``, ``y_proj.fc{1,2}``,
    ``cap_embedder.{0,1}``)."""
    return _map(sd, [('', '', _DIT)], prefix)


def dit2_reference(sd: dict, prefix: str = '') -> dict:
    """``DiT2`` (``pos_embed``, ``blocks.{j}.{within,across}``) → the
    reference ``DiT2``'s alternating ``blocks.{2j}`` / ``blocks.{2j+1}``."""
    rules = [(r'^blocks\.(\d+)\.(within|across)\.',
              lambda m: f'blocks.{2 * int(m[1]) + (m[2] == "across")}.')] \
        + _DIT_BLOCK
    return _map(sd, [('', '', rules)], prefix)


# -- SD encoder / decoder ------------------------------------------------------

_SD = [
    (r'^(down|up)_(\d+)_block_(\d+)\.', r'\1.\2.block.\3.'),
    (r'^down_(\d+)_attn_(\d+)\.', r'down.\1.attn.\2.'),
    (r'^down_(\d+)_downsample\.', r'down.\1.downsample.'),
    (r'^up_(\d+)_upsample\.', r'up.\1.upsample.'),
    (r'^mid_(block_\d|attn_1)\.', r'mid.\1.'),
    (r'\.GroupNorm_0\.', '.'),
    # the 'mv-vanilla' SpatialTransformer3D of the MV encoders
    (r'\.block_(\d+)_norm(\d)\.', r'.transformer_blocks.\1.norm\2.'),
    (r'\.block_(\d+)_attn(\d)_(q|k|v)\.',
     r'.transformer_blocks.\1.attn\2.to_\3.'),
    (r'\.block_(\d+)_attn(\d)_out\.', r'.transformer_blocks.\1.attn\2.to_out.0.'),
    (r'\.block_(\d+)_ff_proj\.', r'.transformer_blocks.\1.ff.net.0.proj.'),
    (r'\.block_(\d+)_ff_out\.', r'.transformer_blocks.\1.ff.net.2.'),
]


_OSG = [(r'^EqualDense_(\d)\.', lambda m: f'net.{2 * int(m[1])}.')]


def vae_objaverse_reference(sd: dict, prefix: str = '') -> dict:
    """``TriplaneVAE`` of the Objaverse release (encoder included) → the
    reference ``rec_model`` names."""
    sup = 'decoder.superresolution.'
    out = _map({k: v for k, v in sd.items() if not k.startswith('dit2.')}, [
        ('encoder.encoder.', 'encoder.', _SD),
        ('encoder.fusion_layer.', 'encoder.fusion_layer.', []),
        ('quant_conv.', f'{sup}quant_conv.', []),
        ('ldm_upsample.', f'{sup}ldm_upsample.proj.', []),
        ('conv_sr.', f'{sup}conv_sr.', _SD),
        ('osg_decoder.', 'decoder.triplane_decoder.decoder.', _OSG)], prefix)
    out.update(dit2_reference(
        {k[5:]: v for k, v in sd.items() if k.startswith('dit2.')},
        f'{prefix}decoder.vit_decoder.'))
    return out


# -- ShapeNet / FFHQ VAEs -----------------------------------------------------

_HUB_DINO = [(r'^patch_embed\.', 'patch_embed.proj.'),
             (r'\.gamma(\d)$', r'.ls\1.gamma')]
_FUSION_V4 = [
    (r'^block_(\d+)\.', r'blocks.\1.'),
    (r'^skip_linear_(\d+)\.', r'blocks.\1.skip_linear.'),
    (r'^(blocks\.\d+)\.blk0\.', r'\1.vit_blks.0.'),
    (r'^(blocks\.\d+)\.(norm1|norm2|mlp)\.', r'\1.vit_blks.1.\2.'),
    (r'^(blocks\.\d+)\.gamma(\d)$', r'\1.vit_blks.1.ls\2.gamma'),
    (r'^(blocks\.\d+)\.attn3d_norm\.', r'\1.vit_blks.1.attn.norm1.'),
    (r'^(blocks\.\d+)\.attn3d\.', r'\1.vit_blks.1.attn.attn.'),
    (r'\.gamma(\d)$', r'.ls\1.gamma'),
]
_FUSION_V3 = [
    (r'^block_(\d+)\.', r'blocks.\1.'),
    (r'^skip_linear_(\d+)\.', r'blocks.\1.skip_linear.'),
    (r'^(blocks\.\d+)\.blk(\d)\.', r'\1.vit_blks.\2.'),
    (r'^(blocks\.\d+)\.attn3d_norm\.', r'\1.fusion.norm1.'),
    (r'^(blocks\.\d+)\.attn3d\.', r'\1.fusion.attn.'),
    (r'\.gamma(\d)$', r'.ls\1.gamma'),
]
_RODIN = [(r'^conv3D_(\d)\.conv\.', r'conv3D_\1.roll_out_convs.')]


def _fusion_vae_reference(sd: dict, prefix: str, ffhq: bool) -> dict:
    sup = 'decoder.superresolution.'
    return _map(sd, [
        ('encoder.', 'encoder.', _HUB_DINO),
        ('ldm_downsample.', f'{sup}ldm_downsample.', []),
        ('quant_conv.', f'{sup}quant_conv.', []),
        ('ldm_upsample.', f'{sup}ldm_upsample.' + ('' if ffhq else 'proj.'),
         []),
        ('fusion_decoder.', 'decoder.vit_decoder.',
         _FUSION_V3 if ffhq else _FUSION_V4),
        ('decoder_pred.', 'decoder.decoder_pred.', []),
        ('conv_sr.', f'{sup}conv_sr.', _RODIN),
        ('osg_decoder.', 'decoder.triplane_decoder.decoder.', _OSG),
        ('superresolution.', 'decoder.triplane_decoder.superresolution.',
         [] if ffhq else [(r'^conv_before_upsample\.',
                           'conv_before_upsample.0.')]),
        ('sr_ws', 'decoder.w_avg', [])], prefix)


def vae_shapenet_reference(sd: dict, prefix: str = '') -> dict:
    """``ShapeNetVAE`` (fusionv5, encoder included) → reference names."""
    return _fusion_vae_reference(sd, prefix, ffhq=False)


def vae_ffhq_reference(sd: dict, prefix: str = '') -> dict:
    """``FFHQVAE`` (4XC_final with the 8XDC head, encoder included) →
    reference names (``sr_ws`` as ``decoder.w_avg``)."""
    return _fusion_vae_reference(sd, prefix, ffhq=True)


# -- U-Net ---------------------------------------------------------------------

def _unet_prefixes(cfg) -> dict:
    """The port's top-level U-Net module names → the reference's
    ``input_blocks`` / ``middle_block`` / ``output_blocks`` paths, in the
    enumeration of the reference constructor."""
    m = {'time_fc1': 'time_embed.0', 'time_fc2': 'time_embed.2',
         'conv_in': 'input_blocks.0.0', 'out_norm': 'out.0',
         'conv_out': 'out.2', 'mid_res_1': 'middle_block.0',
         'mid_attn': 'middle_block.1', 'mid_res_2': 'middle_block.2'}
    levels = len(cfg.channel_mult)
    idx, ds = 1, 1
    for level in range(levels):
        for i in range(cfg.num_res_blocks):
            m[f'down_{level}_res_{i}'] = f'input_blocks.{idx}.0'
            if ds in cfg.attention_resolutions:
                m[f'down_{level}_attn_{i}'] = f'input_blocks.{idx}.1'
            idx += 1
        if level != levels - 1:
            m[f'down_{level}_downsample'] = f'input_blocks.{idx}.0'
            idx, ds = idx + 1, ds * 2
    idx = 0
    for level in reversed(range(levels)):
        for i in range(cfg.num_res_blocks + 1):
            m[f'up_{level}_res_{i}'] = f'output_blocks.{idx}.0'
            sub = 1
            if ds in cfg.attention_resolutions:
                m[f'up_{level}_attn_{i}'] = f'output_blocks.{idx}.{sub}'
                sub += 1
            if level and i == cfg.num_res_blocks:
                m[f'up_{level}_upsample'] = f'output_blocks.{idx}.{sub}'
                ds //= 2
            idx += 1
    return m


_UNET_INNER = [
    (r'^in_norm\.', 'in_layers.0.'), (r'^in_conv\.', 'in_layers.2.'),
    (r'^emb_proj\.', 'emb_layers.1.'), (r'^out_norm\.', 'out_layers.0.'),
    (r'^out_conv\.', 'out_layers.3.'), (r'^skip\.', 'skip_connection.'),
    (r'^block_(\d+)\.(norm\d)\.', r'transformer_blocks.\1.\2.'),
    (r'^block_(\d+)\.attn(\d)_(q|k|v)\.', r'transformer_blocks.\1.attn\2.to_\3.'),
    (r'^block_(\d+)\.attn(\d)_out\.', r'transformer_blocks.\1.attn\2.to_out.0.'),
    (r'^block_(\d+)\.ff_proj\.', r'transformer_blocks.\1.ff.net.0.proj.'),
    (r'^block_(\d+)\.ff_out\.', r'transformer_blocks.\1.ff.net.2.'),
]


def unet_reference(sd: dict, cfg, prefix: str = '') -> dict:
    """``UNetModel`` (spatial transformer, ``resblock_updown=False``, the
    released shape) → the reference LDM/ADM ``UNetModel`` names;
    ``mixing_logit`` (1, 1, 1, C) → (1, C, 1, 1)."""
    top = _unet_prefixes(cfg)
    out = {}
    for k, v in sd.items():
        if k == 'mixing_logit':
            out[f'{prefix}mixing_logit'] = v.permute(0, 3, 1, 2).contiguous()
            continue
        head, _, rest = k.partition('.')
        if head in ('out_norm', 'conv_out', 'time_fc1', 'time_fc2',
                    'conv_in'):
            out[f'{prefix}{top[head]}.{rest}'] = v
        else:
            out[f'{prefix}{top[head]}.{_apply(rest, _UNET_INNER)}'] = v
    return out


# -- generators ----------------------------------------------------------------

def eg3d_reference(sd: dict, prefix: str = 'G_ema.') -> dict:
    """``TriPlaneGenerator`` (``mapping.w_avg`` included) → the reference
    EG3D ``G_ema.backbone.{synthesis,mapping}`` / ``decoder.net`` names;
    the const (H, W, C) → (C, H, W)."""
    sd = dict(sd)
    const = sd.pop('synthesis.const').permute(2, 0, 1).contiguous()
    out = _map(sd, [
        ('synthesis.', 'backbone.synthesis.',
         [(r'^b4_(conv1|torgb)\.', r'b4.\1.')]),
        ('mapping.', 'backbone.mapping.', []),
        ('decoder.', 'decoder.', _OSG)], prefix)
    out[f'{prefix}backbone.synthesis.b4.const'] = const
    return out


def sg3_synthesis_reference(sd: dict, prefix: str = '') -> dict:
    """``SynthesisNetworkSG3`` → reference StyleGAN3 ``SynthesisNetwork``
    names: the input's ``affine_kernel`` (in, out) → ``affine.weight``
    (out, in)."""
    sd = dict(sd)
    out = {f'{prefix}input.affine.weight':
           sd.pop('input.affine_kernel').t().contiguous(),
           f'{prefix}input.affine.bias': sd.pop('input.affine_bias')}
    out.update({prefix + k: v for k, v in sd.items()})
    return out


# -- conditioning towers ---------------------------------------------------------

def clip_text_reference(sd: dict) -> dict:
    """``CLIPTextModel`` → HF ``CLIPTextModel(WithProjection)`` names."""
    return _map(sd, [
        ('token_embedding.', 'text_model.embeddings.token_embedding.', []),
        ('position_embedding',
         'text_model.embeddings.position_embedding.weight', []),
        ('layers.', 'text_model.encoder.layers.', []),
        ('final_layer_norm.', 'text_model.final_layer_norm.', []),
        ('text_projection.', 'text_projection.', [])])


def clip_vision_reference(sd: dict) -> dict:
    """``CLIPVisionModel`` → HF ``CLIPVisionModel`` names."""
    b = 'vision_model.'
    return _map(sd, [
        ('patch_embedding.', f'{b}embeddings.patch_embedding.', []),
        ('class_embedding', f'{b}embeddings.class_embedding', []),
        ('position_embedding', f'{b}embeddings.position_embedding.weight',
         []),
        ('pre_layrnorm.', f'{b}pre_layrnorm.', []),
        ('post_layernorm.', f'{b}post_layernorm.', []),
        ('layers.', f'{b}encoder.layers.', [])])


def dinov2_hf_reference(sd: dict) -> dict:
    """DINOv2 ``VisionTransformer`` → HF ``Dinov2Model`` names; the fused
    ``qkv`` splits into ``query`` / ``key`` / ``value``."""
    out = {}
    rest = {}
    for k, v in sd.items():
        m = re.match(r'^blocks\.(\d+)\.attn\.qkv\.(weight|bias)$', k)
        if m:
            ap = f'dinov2.encoder.layer.{m[1]}.attention.attention'
            for name, part in zip(('query', 'key', 'value'), v.chunk(3)):
                out[f'{ap}.{name}.{m[2]}'] = part.contiguous()
        else:
            rest[k] = v
    out.update(_map(rest, [
        ('patch_embed.', 'dinov2.embeddings.patch_embeddings.projection.',
         []),
        ('cls_token', 'dinov2.embeddings.cls_token', []),
        ('pos_embed', 'dinov2.embeddings.position_embeddings', []),
        ('norm.', 'dinov2.layernorm.', []),
        ('blocks.', 'dinov2.encoder.layer.',
         [(r'\.gamma(\d)$', r'.layer_scale\1.lambda1'),
          (r'\.attn\.proj\.', '.attention.output.dense.')])]))
    return out


def dinov2_hub_reference(sd: dict, prefix: str = '') -> dict:
    """DINOv2 ``VisionTransformer`` → torch-hub DINOv2 names."""
    return _map(sd, [('', '', _HUB_DINO)], prefix)


# VGG16 feature indices of the 13 convs, by ``lpips``' five slices
_LPIPS_CONVS = [(1, 0), (1, 2), (2, 5), (2, 7), (3, 10), (3, 12), (3, 14),
                (4, 17), (4, 19), (4, 21), (5, 24), (5, 26), (5, 28)]


def lpips_reference(sd: dict) -> dict:
    """``LPIPS`` → ``lpips.LPIPS(net='vgg')`` names: ``net.slice{s}.{i}``
    convs and ``lin{i}.model.1.weight`` heads (1, C, 1, 1)."""
    out = {}
    for k, v in sd.items():
        m = re.match(r'^vgg\.conv(\d+)\.(weight|bias)$', k)
        if m:
            s, i = _LPIPS_CONVS[int(m[1])]
            out[f'net.slice{s}.{i}.{m[2]}'] = v
        else:
            out[f'{k}.model.1.weight'] = v.reshape(1, -1, 1, 1)
    return out


# -- joint checkpoints -----------------------------------------------------------

def joint_objaverse_reference(den_sd: dict, vae_sd: dict,
                              mixing_logit=None) -> dict:
    """A ``model_joint_denoise_rec_model`` dict of the Objaverse DiT
    releases: ``ddpm_model.*`` (the DiT, and the top-level
    ``mixing_logit`` buffer when given) + ``rec_model.*`` (the VAE)."""
    out = dit_reference(den_sd, 'ddpm_model.')
    if mixing_logit is not None:
        out['ddpm_model.mixing_logit'] = mixing_logit
    out.update(vae_objaverse_reference(vae_sd, 'rec_model.'))
    return out


def joint_shapenet_reference(unet_sd: dict, vae_sd: dict, cfg) -> dict:
    """The ShapeNet release's joint dict: the U-Net (its mixing logit
    inside) + the fusionv5 VAE."""
    out = unet_reference(unet_sd, cfg, 'ddpm_model.')
    out.update(vae_shapenet_reference(vae_sd, 'rec_model.'))
    return out


# -- legacy persistence pickles ---------------------------------------------------

class _Persistent:
    """Pickles as the reference's ``persistence.py`` decorates a module:
    ``(_reconstruct_persistent_obj, (meta,), None)``."""

    def __init__(self, meta):
        self.meta = meta

    def __reduce__(self):
        import sys
        return (sys.modules['torch_utils.persistence']
                ._reconstruct_persistent_obj, (self.meta,), None)


def _persistent_tree(flat: dict, class_name: str, module_src: str,
                     buffers=()):
    """A flat ``{dotted name: tensor}`` dict as nested persistent objects
    whose ``_parameters`` / ``_buffers`` / ``_modules`` give those names
    back (``buffers``: name suffixes stored as buffers)."""
    from collections import OrderedDict
    params, bufs, children = OrderedDict(), OrderedDict(), {}
    for k, v in flat.items():
        head, dot, rest = k.partition('.')
        if dot:
            children.setdefault(head, {})[rest] = v
        elif k.endswith(tuple(buffers)):
            bufs[k] = v
        else:
            params[k] = torch.nn.Parameter(v, requires_grad=False)
    mods = OrderedDict((k, _persistent_tree(v, 'Module', module_src,
                                            buffers))
                       for k, v in children.items())
    state = {'training': False, '_parameters': params, '_buffers': bufs,
             '_modules': mods, '_init_args': (), '_init_kwargs': {}}
    return _Persistent(dict(type='class', version=4, module_src=module_src,
                            class_name=class_name, state=state))


def write_persistence_pickle(path: str, networks: dict, module_src: str,
                             buffers=('w_avg', 'noise_const')):
    """Write a StyleGAN training pickle (``{'G': ..., 'D': ..., 'G_ema':
    ..., 'training_set_kwargs': ...}``, reference ``legacy.py``) of the
    flat reference-named state dicts ``networks`` (name → dict; None for
    an absent network).  Every module pickles through the persistence
    protocol with ``module_src`` as its source text, which a loader that
    executes pickled source would run."""
    import pickle
    import sys
    import types
    parent = types.ModuleType('torch_utils')
    fake = types.ModuleType('torch_utils.persistence')
    parent.persistence = fake

    def _reconstruct_persistent_obj(meta):
        raise RuntimeError('only for pickling')

    _reconstruct_persistent_obj.__module__ = fake.__name__
    _reconstruct_persistent_obj.__qualname__ = '_reconstruct_persistent_obj'
    fake._reconstruct_persistent_obj = _reconstruct_persistent_obj
    saved = {k: sys.modules.get(k) for k in ('torch_utils', fake.__name__)}
    sys.modules.update({'torch_utils': parent, fake.__name__: fake})
    try:
        data = {k: None if v is None else _persistent_tree(
            v, 'TriPlaneGenerator', module_src, buffers)
            for k, v in networks.items()}
        data['training_set_kwargs'] = {'resolution': 512}
        with open(path, 'wb') as f:
            pickle.dump(data, f)
    finally:
        for k, mod in saved.items():
            if mod is None:
                del sys.modules[k]
            else:
                sys.modules[k] = mod
