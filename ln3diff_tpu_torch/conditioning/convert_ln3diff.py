"""Converters from the reference LN3Diff checkpoint naming to the JAX
package's parameter layout.

Port of ``ln3diff_tpu/conditioning/convert_ln3diff.py``, all 36
functions, in numpy only: from ``convert_sd_encoder`` (:29) to
``convert_stylegan3_synthesis`` (:749), with the released denoisers
(``convert_dit_trilatent`` :228 for every ``variant``, ``convert_unet``
:311), the VAEs (``convert_vae_{shapenet,ffhq,objaverse}`` :551/:578/:618),
the joint checkpoints (``convert_joint_{objaverse,shapenet}`` :647/:668),
the FFHQ SR head (``convert_sr_hybrid_8xdc`` :537) and the EG3D and
StyleGAN3 generators (:705, :749).  The released checkpoints
(``model_joint_denoise_rec_model*.safetensors``) store torch state dicts
under the reference's module names; each converter returns the JAX
package's tree for them, leaf for leaf (nested dicts of numpy arrays,
``nn.scan``-stacked blocks, ``_``-prefixed 'stats' leaves), and
``bridge.reference_state_dicts`` carries that tree onto the port's
modules.  ``convert_unet`` takes the port's ``UNetConfig``.

Two departures, each a leaf that the JAX converter leaves out although
its module has it (``ROADMAP.md`` §3), converted here when the reference
dict holds it: the PixArt variants' shared ``adaLN_modulation.1`` (one
modulation Linear ahead of the blocks) in ``convert_dit_trilatent``, and
the 4-view ``MVEncoder``'s ``encoder.fusion_layer`` conv in
``convert_vae_objaverse``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .convert import (_np, conv2d, group_norm, layer_norm, linear,
                      split_joint_checkpoint)


def convert_sd_encoder(sd: Mapping, ch_mult=(1, 2, 4, 4),
                       num_res_blocks: int = 1,
                       attn_resolutions=(), prefix: str = '',
                       mv: bool = False) -> dict:
    """Reference ``Encoder`` state_dict → our ``Encoder`` params.

    ``mv=True`` selects the 'mv-vanilla' attention layout
    (``SpatialTransformer3D`` — the MVEncoder* classes,
    ``ldm/modules/diffusionmodules/model.py:563-624``)."""
    p = prefix
    attn = _mv_attn if mv else _attn_block
    params: dict = {'conv_in': conv2d(sd, f'{p}conv_in')}
    num_resolutions = len(ch_mult)
    for i in range(num_resolutions):
        for j in range(num_res_blocks):
            params[f'down_{i}_block_{j}'] = _resnet_block(
                sd, f'{p}down.{i}.block.{j}')
            if f'{p}down.{i}.attn.{j}.norm.weight' in sd:
                params[f'down_{i}_attn_{j}'] = attn(
                    sd, f'{p}down.{i}.attn.{j}')
        if i != num_resolutions - 1:
            params[f'down_{i}_downsample'] = {
                'conv': conv2d(sd, f'{p}down.{i}.downsample.conv')}
    params['mid_block_1'] = _resnet_block(sd, f'{p}mid.block_1')
    params['mid_attn_1'] = attn(sd, f'{p}mid.attn_1')
    params['mid_block_2'] = _resnet_block(sd, f'{p}mid.block_2')
    params['norm_out'] = {'GroupNorm_0': group_norm(sd, f'{p}norm_out')}
    params['conv_out'] = conv2d(sd, f'{p}conv_out')
    return params


def convert_sd_decoder(sd: Mapping, ch_mult=(1, 2, 2, 4),
                       num_res_blocks: int = 1,
                       prefix: str = '') -> dict:
    """Reference ``Decoder`` state_dict → our ``Decoder`` params."""
    p = prefix
    params: dict = {'conv_in': conv2d(sd, f'{p}conv_in')}
    params['mid_block_1'] = _resnet_block(sd, f'{p}mid.block_1')
    params['mid_attn_1'] = _attn_block(sd, f'{p}mid.attn_1')
    params['mid_block_2'] = _resnet_block(sd, f'{p}mid.block_2')
    for i in reversed(range(len(ch_mult))):
        for j in range(num_res_blocks + 1):
            params[f'up_{i}_block_{j}'] = _resnet_block(
                sd, f'{p}up.{i}.block.{j}')
        if i != 0:
            params[f'up_{i}_upsample'] = {
                'conv': conv2d(sd, f'{p}up.{i}.upsample.conv')}
    params['norm_out'] = {'GroupNorm_0': group_norm(sd, f'{p}norm_out')}
    params['conv_out'] = conv2d(sd, f'{p}conv_out')
    return params


def _resnet_block(sd: Mapping, p: str) -> dict:
    out = {
        'norm1': {'GroupNorm_0': group_norm(sd, f'{p}.norm1')},
        'conv1': conv2d(sd, f'{p}.conv1'),
        'norm2': {'GroupNorm_0': group_norm(sd, f'{p}.norm2')},
        'conv2': conv2d(sd, f'{p}.conv2'),
    }
    if f'{p}.nin_shortcut.weight' in sd:
        out['nin_shortcut'] = conv2d(sd, f'{p}.nin_shortcut')
    return out


def _attn_block(sd: Mapping, p: str) -> dict:
    return {
        'norm': {'GroupNorm_0': group_norm(sd, f'{p}.norm')},
        'q': conv2d(sd, f'{p}.q'),
        'k': conv2d(sd, f'{p}.k'),
        'v': conv2d(sd, f'{p}.v'),
        'proj_out': conv2d(sd, f'{p}.proj_out'),
    }


def _mv_attn(sd: Mapping, p: str, depth: int = 1) -> dict:
    """Reference 'mv-vanilla' ``SpatialTransformer3D``
    (``ldm/modules/attention.py:405-463``) → our ``MVAttn`` params."""
    out: dict = {
        'norm': {'GroupNorm_0': group_norm(sd, f'{p}.norm')},
        'proj_in': conv2d(sd, f'{p}.proj_in'),
        'proj_out': conv2d(sd, f'{p}.proj_out'),
    }
    for d in range(depth):
        b = f'{p}.transformer_blocks.{d}'
        out.update({
            f'block_{d}_norm1': layer_norm(sd, f'{b}.norm1'),
            f'block_{d}_norm2': layer_norm(sd, f'{b}.norm2'),
            f'block_{d}_norm3': layer_norm(sd, f'{b}.norm3'),
            f'block_{d}_attn1_q': linear(sd, f'{b}.attn1.to_q'),
            f'block_{d}_attn1_k': linear(sd, f'{b}.attn1.to_k'),
            f'block_{d}_attn1_v': linear(sd, f'{b}.attn1.to_v'),
            f'block_{d}_attn1_out': linear(sd, f'{b}.attn1.to_out.0'),
            f'block_{d}_attn2_q': linear(sd, f'{b}.attn2.to_q'),
            f'block_{d}_attn2_k': linear(sd, f'{b}.attn2.to_k'),
            f'block_{d}_attn2_v': linear(sd, f'{b}.attn2.to_v'),
            f'block_{d}_attn2_out': linear(sd, f'{b}.attn2.to_out.0'),
            f'block_{d}_ff_proj': linear(sd, f'{b}.ff.net.0.proj'),
            f'block_{d}_ff_out': linear(sd, f'{b}.ff.net.2'),
        })
    return out


def convert_osg_decoder(sd: Mapping, prefix: str = 'decoder.net') -> dict:
    """Reference ``OSGDecoder`` (two StyleGAN FullyConnectedLayers,
    ``nsr/triplane.py:338-375``) → our ``OSGDecoder``.

    StyleGAN FC stores raw weight (out, in) applied as
    ``x @ (w.T * lr_mul/sqrt(in))`` — identical runtime scaling to our
    ``EqualDense``, so weights copy over transposed, biases verbatim.
    """
    return {
        'EqualDense_0': {
            'kernel': _np(sd[f'{prefix}.0.weight']).T,
            'bias': _np(sd[f'{prefix}.0.bias']),
        },
        'EqualDense_1': {
            'kernel': _np(sd[f'{prefix}.2.weight']).T,
            'bias': _np(sd[f'{prefix}.2.bias']),
        },
    }


def convert_quant_conv(sd: Mapping, prefix: str = 'superresolution.quant_conv'
                       ) -> dict:
    """Grouped 1x1 quant conv (reference ``vit_triplane.py:854``)."""
    return conv2d(sd, prefix)


# ---------------------------------------------------------------------------
# Stage-2 denoisers (reference dit/dit_trilatent.py, dit/dit_i23d.py)
# ---------------------------------------------------------------------------

def _stack(trees: list) -> dict:
    """Stack a list of identical param trees along a new axis 0 (the
    ``nn.scan`` weight-stacked block layout)."""
    out: dict = {}
    for k in trees[0]:
        vals = [t[k] for t in trees]
        if isinstance(vals[0], dict):
            out[k] = _stack(vals)
        else:
            out[k] = np.stack(vals, axis=0)
    return out


def _dit_attn(sd: Mapping, p: str) -> dict:
    out = {'qkv': linear(sd, f'{p}.qkv'), 'proj': linear(sd, f'{p}.proj')}
    if f'{p}.q_norm.weight' in sd:
        out['q_norm'] = {'scale': _np(sd[f'{p}.q_norm.weight'])}
        out['k_norm'] = {'scale': _np(sd[f'{p}.k_norm.weight'])}
    return out


def _dit_cross_attn(sd: Mapping, p: str) -> dict:
    return {
        'to_q': linear(sd, f'{p}.to_q'),
        'to_k': linear(sd, f'{p}.to_k'),
        'to_v': linear(sd, f'{p}.to_v'),
        'to_out': linear(sd, f'{p}.to_out.0'),
    }


def _fused_mlp(sd: Mapping, p: str) -> dict:
    """xformers FusedMLP (``mlp.0``/``mlp.2`` Linears)."""
    return {'fc1': linear(sd, f'{p}.mlp.0'), 'fc2': linear(sd, f'{p}.mlp.2')}


def _dit_block(sd: Mapping, p: str, variant: str) -> dict:
    blk: dict = {
        'attn': _dit_attn(sd, f'{p}.attn'),
        'mlp': _fused_mlp(sd, f'{p}.mlp'),
    }
    if f'{p}.adaLN_modulation.1.weight' in sd:
        blk['adaLN_modulation'] = linear(sd, f'{p}.adaLN_modulation.1')
    if f'{p}.scale_shift_table' in sd:
        blk['scale_shift_table'] = _np(sd[f'{p}.scale_shift_table'])
    if f'{p}.cross_attn.to_q.weight' in sd:
        blk['cross_attn'] = _dit_cross_attn(sd, f'{p}.cross_attn')
    if f'{p}.attention_y_norm.weight' in sd:
        blk['attention_y_norm'] = {
            'scale': _np(sd[f'{p}.attention_y_norm.weight'])}
    if f'{p}.norm1.weight' in sd:      # rmsnorm variants carry scales
        blk['norm1'] = {'scale': _np(sd[f'{p}.norm1.weight'])}
        blk['norm2'] = {'scale': _np(sd[f'{p}.norm2.weight'])}
    return blk


def _caption_embedder(sd: Mapping, p: str, token_num: int = 77,
                      context_dim: int = 768) -> dict:
    """Reference CaptionEmbedder (timm Mlp ``y_proj.fc1/fc2``); the JAX
    module also owns a ``y_embedding`` null-caption table the reference
    dropped — keep zeros so CFG-dropout falls back to the zero caption."""
    return {
        'fc1': linear(sd, f'{p}.y_proj.fc1'),
        'fc2': linear(sd, f'{p}.y_proj.fc2'),
        'y_embedding': np.zeros((token_num, context_dim), np.float32),
    }


def convert_dit_trilatent(sd: Mapping, depth: int, prefix: str = '',
                          variant: str = 'text') -> dict:
    """Reference ``DiT_TriLatent`` (t23d DiT-L/2, vit_blk=TextCondDiTBlock,
    ``guided_diffusion/script_util.py:408-415``) / PixArt / I23D variants →
    our ``DiT_TriLatent`` params.

    The JAX blocks are ``nn.scan`` weight-stacked: per-block reference
    tensors stack along a leading depth axis.
    """
    p = prefix
    params: dict = {
        't_embedder': {'fc1': linear(sd, f'{p}t_embedder.mlp.0'),
                       'fc2': linear(sd, f'{p}t_embedder.mlp.2')},
        'x_embedder': {'proj': conv2d(sd, f'{p}x_embedder.proj')},
        'final_layer': {'linear': linear(sd, f'{p}final_layer.linear')},
        'blocks': {'block': _stack([
            _dit_block(sd, f'{p}blocks.{i}', variant)
            for i in range(depth)])},
    }
    if f'{p}adaLN_modulation.1.weight' in sd:   # PixArt shared adaLN
        params['adaLN_modulation'] = linear(sd, f'{p}adaLN_modulation.1')
    if f'{p}final_layer.adaLN_modulation.1.weight' in sd:
        params['final_layer']['adaLN_modulation'] = linear(
            sd, f'{p}final_layer.adaLN_modulation.1')
    if f'{p}final_layer.scale_shift_table' in sd:
        params['final_layer']['scale_shift_table'] = _np(
            sd[f'{p}final_layer.scale_shift_table'])
    if f'{p}clip_text_proj.y_proj.fc1.weight' in sd:
        ctx = _np(sd[f'{p}clip_text_proj.y_proj.fc1.weight']).shape[1]
        params['clip_text_proj'] = _caption_embedder(
            sd, f'{p}clip_text_proj', context_dim=ctx)
    if f'{p}cap_embedder.0.weight' in sd:   # PixArt pooled-vector path
        params['cap_norm'] = layer_norm(sd, f'{p}cap_embedder.0')
        params['cap_proj'] = linear(sd, f'{p}cap_embedder.1')
    if f'{p}dino_proj.y_proj.fc1.weight' in sd:
        ctx = _np(sd[f'{p}dino_proj.y_proj.fc1.weight']).shape[1]
        params['dino_proj'] = _caption_embedder(sd, f'{p}dino_proj',
                                                context_dim=ctx)
    return params


def _adm_resblock(sd: Mapping, p: str) -> dict:
    """Reference ADM ``ResBlock`` (``guided_diffusion/unet.py:163-280``:
    in_layers[norm,silu,conv], emb_layers[silu,linear],
    out_layers[norm,silu,drop,conv], skip_connection)."""
    out = {
        'in_norm': group_norm(sd, f'{p}.in_layers.0'),
        'in_conv': conv2d(sd, f'{p}.in_layers.2'),
        'emb_proj': linear(sd, f'{p}.emb_layers.1'),
        'out_norm': group_norm(sd, f'{p}.out_layers.0'),
        'out_conv': conv2d(sd, f'{p}.out_layers.3'),
    }
    if f'{p}.skip_connection.weight' in sd:
        out['skip'] = conv2d(sd, f'{p}.skip_connection')
    return out


def _spatial_transformer(sd: Mapping, p: str, depth: int = 1) -> dict:
    """LDM ``SpatialTransformer`` (``ldm/modules/attention.py:343-386``)
    with ``BasicTransformerBlock`` GEGLU blocks."""
    out: dict = {
        'norm': group_norm(sd, f'{p}.norm'),
        'proj_in': conv2d(sd, f'{p}.proj_in'),
        'proj_out': conv2d(sd, f'{p}.proj_out'),
    }
    for d in range(depth):
        b = f'{p}.transformer_blocks.{d}'
        out[f'block_{d}'] = {
            'norm1': layer_norm(sd, f'{b}.norm1'),
            'norm2': layer_norm(sd, f'{b}.norm2'),
            'norm3': layer_norm(sd, f'{b}.norm3'),
            'attn1_q': linear(sd, f'{b}.attn1.to_q'),
            'attn1_k': linear(sd, f'{b}.attn1.to_k'),
            'attn1_v': linear(sd, f'{b}.attn1.to_v'),
            'attn1_out': linear(sd, f'{b}.attn1.to_out.0'),
            'attn2_q': linear(sd, f'{b}.attn2.to_q'),
            'attn2_k': linear(sd, f'{b}.attn2.to_k'),
            'attn2_v': linear(sd, f'{b}.attn2.to_v'),
            'attn2_out': linear(sd, f'{b}.attn2.to_out.0'),
            'ff_proj': linear(sd, f'{b}.ff.net.0.proj'),
            'ff_out': linear(sd, f'{b}.ff.net.2'),
        }
    return out


def convert_unet(sd: Mapping, cfg, prefix: str = '') -> dict:
    """Reference LDM/ADM ``UNetModel`` (``guided_diffusion/unet.py:
    427-1024``, ``resblock_updown=False`` + spatial transformer — the
    released ShapeNet/FFHQ denoiser shape) → our ``UNetModel`` params.

    ``cfg`` is our ``UNetConfig``; the input/output block enumeration
    mirrors the reference constructor so sub-module indices line up.
    """
    p = prefix
    td = cfg.transformer_depth
    params: dict = {
        'time_fc1': linear(sd, f'{p}time_embed.0'),
        'time_fc2': linear(sd, f'{p}time_embed.2'),
        'conv_in': conv2d(sd, f'{p}input_blocks.0.0'),
        'out_norm': group_norm(sd, f'{p}out.0'),
        'conv_out': conv2d(sd, f'{p}out.2'),
    }
    if f'{p}mixing_logit' in sd:
        ml = _np(sd[f'{p}mixing_logit'])          # (1, C, 1, 1)
        params['mixing_logit'] = ml.transpose(0, 2, 3, 1)

    idx = 1
    ds = 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            params[f'down_{level}_res_{i}'] = _adm_resblock(
                sd, f'{p}input_blocks.{idx}.0')
            if ds in cfg.attention_resolutions:
                params[f'down_{level}_attn_{i}'] = _spatial_transformer(
                    sd, f'{p}input_blocks.{idx}.1', td)
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            params[f'down_{level}_downsample'] = {
                'op': conv2d(sd, f'{p}input_blocks.{idx}.0.op')}
            idx += 1
            ds *= 2

    params['mid_res_1'] = _adm_resblock(sd, f'{p}middle_block.0')
    params['mid_attn'] = _spatial_transformer(sd, f'{p}middle_block.1', td)
    params['mid_res_2'] = _adm_resblock(sd, f'{p}middle_block.2')

    idx = 0
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            params[f'up_{level}_res_{i}'] = _adm_resblock(
                sd, f'{p}output_blocks.{idx}.0')
            sub = 1
            if ds in cfg.attention_resolutions:
                params[f'up_{level}_attn_{i}'] = _spatial_transformer(
                    sd, f'{p}output_blocks.{idx}.{sub}', td)
                sub += 1
            if level and i == cfg.num_res_blocks:
                params[f'up_{level}_upsample'] = {
                    'conv': conv2d(sd, f'{p}output_blocks.{idx}.{sub}.conv')}
                ds //= 2
            idx += 1
    return params


def convert_patch_embed_triplane(sd: Mapping,
                                 prefix: str = 'superresolution.ldm_upsample'
                                 ) -> dict:
    """Reference ``PatchEmbedTriplane`` (``vit/vit_triplane.py:58-108``):
    a single grouped conv ``proj`` (groups=3)."""
    return {'proj': conv2d(sd, f'{prefix}.proj')}


def convert_dit2(sd: Mapping, depth: int, prefix: str = '') -> dict:
    """Reference ``DiT2`` VAE decoder backbone (``dit/dit_decoder.py``) →
    our ``DiT2`` params.  Blocks alternate within-plane (even) /
    cross-plane (odd); our scan stacks them as (within, across) pairs."""
    p = prefix
    within = [_dit_block(sd, f'{p}blocks.{i}', 'adaln')
              for i in range(0, depth, 2)]
    across = [_dit_block(sd, f'{p}blocks.{i}', 'adaln')
              for i in range(1, depth, 2)]
    return {
        'pos_embed': _np(sd[f'{p}pos_embed']),    # (1, n*L, D)
        'blocks': {'within': _stack(within), 'across': _stack(across)},
    }


# ---------------------------------------------------------------------------
# Released ShapeNet arch (fusionv5): hub-DINOv2 encoder + fusion decoder
# ---------------------------------------------------------------------------

def _dinov2_block(sd: Mapping, p: str) -> dict:
    """One hub-DINOv2 block (facebookresearch/dinov2 naming:
    norm1/attn.qkv/attn.proj/ls1.gamma/norm2/mlp.fc1/fc2/ls2.gamma) →
    our ``ViTBlock`` params."""
    return {
        'norm1': layer_norm(sd, f'{p}.norm1'),
        'norm2': layer_norm(sd, f'{p}.norm2'),
        'gamma1': _np(sd[f'{p}.ls1.gamma']),
        'gamma2': _np(sd[f'{p}.ls2.gamma']),
        'attn': {'qkv': linear(sd, f'{p}.attn.qkv'),
                 'proj': linear(sd, f'{p}.attn.proj')},
        'mlp': {'fc1': linear(sd, f'{p}.mlp.fc1'),
                'fc2': linear(sd, f'{p}.mlp.fc2')},
    }


def convert_hub_dinov2(sd: Mapping, depth: int, prefix: str = '') -> dict:
    """Hub DINOv2 ``VisionTransformer`` state dict (the ShapeNet/FFHQ
    encoder, loaded via torch.hub in ``nsr/script_util.py:1233-1240``) →
    our scan-stacked ``VisionTransformer`` params."""
    p = prefix
    return {
        'patch_embed': conv2d(sd, f'{p}patch_embed.proj'),
        'cls_token': _np(sd[f'{p}cls_token']),
        'pos_embed': _np(sd[f'{p}pos_embed']),
        'blocks': {'block': _stack([
            _dinov2_block(sd, f'{p}blocks.{i}') for i in range(depth)])},
        'norm': layer_norm(sd, f'{p}norm'),
    }


def convert_dino_fusion_block(sd: Mapping, p: str) -> dict:
    """Reference ``TriplaneFusionBlockv4_nested_init_from_dino``
    (``vit/vision_transformer.py:2062-2143``) → our ``DinoFusionBlock``.

    vit_blks.0 is a stock DINOv2 block; vit_blks.1 keeps its norms /
    mlp / layerscales but its ``attn`` was replaced by the residual
    Conv3DCrossAttentionBlockXformerMHANested (inner norm1 + xygrid
    wq/w_kv/proj)."""
    b1 = f'{p}.vit_blks.1'
    return {
        'blk0': _dinov2_block(sd, f'{p}.vit_blks.0'),
        'norm1': layer_norm(sd, f'{b1}.norm1'),
        'norm2': layer_norm(sd, f'{b1}.norm2'),
        'gamma1': _np(sd[f'{b1}.ls1.gamma']),
        'gamma2': _np(sd[f'{b1}.ls2.gamma']),
        'mlp': {'fc1': linear(sd, f'{b1}.mlp.fc1'),
                'fc2': linear(sd, f'{b1}.mlp.fc2')},
        'attn3d_norm': layer_norm(sd, f'{b1}.attn.norm1'),
        'attn3d': {'wq': linear(sd, f'{b1}.attn.attn.wq'),
                   'w_kv': linear(sd, f'{b1}.attn.attn.w_kv'),
                   'proj': linear(sd, f'{b1}.attn.attn.proj')},
    }


def convert_dino_fusion_block_v3(sd: Mapping, p: str) -> dict:
    """Reference ``TriplaneFusionBlockv3`` (FFHQ decoder block,
    ``vit/vision_transformer.py:1940-1953``): both DINOv2 blocks intact,
    plus one residual xygrid fusion attention."""
    return {
        'blk0': _dinov2_block(sd, f'{p}.vit_blks.0'),
        'blk1': _dinov2_block(sd, f'{p}.vit_blks.1'),
        'attn3d_norm': layer_norm(sd, f'{p}.fusion.norm1'),
        'attn3d': {'wq': linear(sd, f'{p}.fusion.attn.wq'),
                   'w_kv': linear(sd, f'{p}.fusion.attn.w_kv'),
                   'proj': linear(sd, f'{p}.fusion.attn.proj')},
    }


def convert_dino_fusion_decoder(sd: Mapping, depth: int = 6,
                                prefix: str = '',
                                variant: str = 'v4') -> dict:
    """Fused vit_decoder of the fusionv5/4XC families: ``blocks.{g}``
    fusion blocks (+ ``skip_linear`` on the second half,
    ``create_uvit_arch`` ``vit/vit_triplane.py:313``), replaced
    ``pos_embed``, final norm."""
    p = prefix
    blk = (convert_dino_fusion_block_v3 if variant == 'v3'
           else convert_dino_fusion_block)
    out: dict = {
        'pos_embed': _np(sd[f'{p}pos_embed']).reshape(1, -1,
                                                      _np(sd[f'{p}pos_embed']
                                                          ).shape[-1]),
        'norm': layer_norm(sd, f'{p}norm'),
    }
    for g in range(depth):
        out[f'block_{g}'] = blk(sd, f'{p}blocks.{g}')
        if f'{p}blocks.{g}.skip_linear.weight' in sd:
            out[f'skip_linear_{g}'] = linear(sd,
                                             f'{p}blocks.{g}.skip_linear')
    return out


def convert_rodin_sr(sd: Mapping, prefix: str = '') -> dict:
    """``RodinConv3D4X_lite_mlp_as_residual(_lite)`` → our
    ``RodinConv3D4XResidual`` params."""
    p = prefix
    out = {
        'conv3D_0': {'conv': conv2d(
            sd, f'{p}conv3D_0.roll_out_inplane_conv'
            if f'{p}conv3D_0.roll_out_inplane_conv.weight' in sd
            else f'{p}conv3D_0.roll_out_convs')},
        'conv3D_1': {'conv': conv2d(sd, f'{p}conv3D_1.roll_out_convs')},
    }
    if f'{p}short_cut.weight' in sd:
        out['short_cut'] = linear(sd, f'{p}short_cut')
    return out


def convert_nearest_conv_sr(sd: Mapping, prefix: str = '') -> dict:
    """``NearestConvSR(_Residual)`` (``utils/torch_utils/components.py:
    367-420``) → our ``NearestConvSR`` params (same conv names;
    ``conv_before_upsample`` is a Sequential, index .0)."""
    p = prefix
    out = {
        'conv_after_body': conv2d(sd, f'{p}conv_after_body'),
        'conv_before_upsample': conv2d(sd, f'{p}conv_before_upsample.0'),
        'conv_up1': conv2d(sd, f'{p}conv_up1'),
        'conv_hr': conv2d(sd, f'{p}conv_hr'),
        'conv_last': conv2d(sd, f'{p}conv_last'),
    }
    if f'{p}conv_up2.weight' in sd:
        out['conv_up2'] = conv2d(sd, f'{p}conv_up2')
    return out


def _sg2_layer(sd: Mapping, p: str, torgb: bool = False) -> dict:
    """StyleGAN2 SynthesisLayer / ToRGBLayer → our SG2 modules."""
    out = {
        'affine': {'kernel': _np(sd[f'{p}.affine.weight']).T,
                   'bias': _np(sd[f'{p}.affine.bias'])},
        'weight': _np(sd[f'{p}.weight']).transpose(2, 3, 1, 0),
        'bias': _np(sd[f'{p}.bias']),
    }
    if not torgb and f'{p}.noise_strength' in sd:
        out['noise_strength'] = _np(sd[f'{p}.noise_strength'])
        out['noise_const'] = _np(sd[f'{p}.noise_const'])
    return out


def convert_sr_hybrid_8xdc(sd: Mapping, prefix: str = '') -> dict:
    """Reference ``SuperresolutionHybrid8XDC`` (``nsr/superresolution.py:
    384-446``) → our params: two skip SynthesisBlocks."""
    p = prefix
    out: dict = {}
    for b in ('block0', 'block1'):
        out[b] = {
            'conv0': _sg2_layer(sd, f'{p}{b}.conv0'),
            'conv1': _sg2_layer(sd, f'{p}{b}.conv1'),
            'torgb': _sg2_layer(sd, f'{p}{b}.torgb', torgb=True),
        }
    return out


def convert_vae_shapenet(sd: Mapping, fusion_depth: int = 6,
                         encoder_depth: int = 12, prefix: str = '') -> dict:
    """Reference ShapeNet release ``rec_model`` state dict (fusionv5) →
    our ``ShapeNetVAE`` param tree."""
    p = prefix
    out = {
        'encoder': convert_hub_dinov2(sd, encoder_depth,
                                      prefix=f'{p}encoder.'),
        'ldm_downsample': linear(
            sd, f'{p}decoder.superresolution.ldm_downsample'),
        'quant_conv': conv2d(sd, f'{p}decoder.superresolution.quant_conv'),
        'ldm_upsample': conv2d(
            sd, f'{p}decoder.superresolution.ldm_upsample.proj'),
        'fusion_decoder': convert_dino_fusion_decoder(
            sd, fusion_depth, prefix=f'{p}decoder.vit_decoder.'),
        'decoder_pred': linear(sd, f'{p}decoder.decoder_pred'),
        'conv_sr': convert_rodin_sr(
            sd, prefix=f'{p}decoder.superresolution.conv_sr.'),
        'osg_decoder': convert_osg_decoder(
            sd, prefix=f'{p}decoder.triplane_decoder.decoder.net'),
    }
    sr_prefix = f'{p}decoder.triplane_decoder.superresolution.'
    if f'{sr_prefix}conv_after_body.weight' in sd:
        out['superresolution'] = convert_nearest_conv_sr(sd, sr_prefix)
    return out


def convert_vae_ffhq(sd: Mapping, fusion_depth: int = 6,
                     encoder_depth: int = 12, prefix: str = '') -> dict:
    """Reference FFHQ release ``rec_model`` state dict (4XC_final,
    ``vit/vit_triplane.py:516``) → our ``FFHQVAE`` param tree.

    The upstream encode path is dead code (see ``FFHQVAE`` docstring);
    its vestigial ``quant_conv`` is converted only when the stored
    shapes match our grouped 24→24 conv."""
    p = prefix
    out = {
        'encoder': convert_hub_dinov2(sd, encoder_depth,
                                      prefix=f'{p}encoder.'),
        'ldm_downsample': linear(
            sd, f'{p}decoder.superresolution.ldm_downsample'),
        'ldm_upsample': linear(
            sd, f'{p}decoder.superresolution.ldm_upsample'),
        'fusion_decoder': convert_dino_fusion_decoder(
            sd, fusion_depth, prefix=f'{p}decoder.vit_decoder.',
            variant='v3'),
        'decoder_pred': linear(sd, f'{p}decoder.decoder_pred'),
        'conv_sr': convert_rodin_sr(
            sd, prefix=f'{p}decoder.superresolution.conv_sr.'),
        'osg_decoder': convert_osg_decoder(
            sd, prefix=f'{p}decoder.triplane_decoder.decoder.net'),
        'superresolution': convert_sr_hybrid_8xdc(
            sd, prefix=f'{p}decoder.triplane_decoder.superresolution.'),
    }
    if f'{p}decoder.w_avg' in sd:
        out['sr_ws'] = _np(sd[f'{p}decoder.w_avg'])
    qk = f'{p}decoder.superresolution.quant_conv.weight'
    if qk in sd and _np(sd[qk]).shape[0] == 24:
        out['quant_conv'] = conv2d(sd,
                                   f'{p}decoder.superresolution.quant_conv')
    return out


# ---------------------------------------------------------------------------
# Full joint checkpoint (model_joint_denoise_rec_model*.safetensors)
# ---------------------------------------------------------------------------

def convert_vae_objaverse(sd: Mapping, dit2_depth: int = 24,
                          prefix: str = '',
                          enc_ch_mult=(1, 2, 4, 4),
                          dec_ch_mult=(1, 2, 2, 4),
                          num_res_blocks: int = 1) -> dict:
    """Reference Objaverse release ``rec_model`` state dict
    (``RodinSR_256_..._withSD_D_ditDecoder``, assembled by
    ``nsr/script_util.py:create_3DAE_model``) → our ``TriplaneVAE``
    param tree.  Submodules: MVEncoderGSDynamicInp encoder, grouped
    quant_conv + PatchEmbedTriplane ldm_upsample, DiT2 backbone, SD
    ``Decoder`` conv_sr deconv, OSG point decoder."""
    p = prefix
    encoder = {'encoder': convert_sd_encoder(
        sd, ch_mult=enc_ch_mult, num_res_blocks=num_res_blocks,
        prefix=f'{p}encoder.', mv=True)}
    if f'{p}encoder.fusion_layer.weight' in sd:   # MVEncoder's view fusion
        encoder['fusion_layer'] = conv2d(sd, f'{p}encoder.fusion_layer')
    return {
        'encoder': encoder,
        'quant_conv': conv2d(sd, f'{p}decoder.superresolution.quant_conv'),
        'ldm_upsample': conv2d(
            sd, f'{p}decoder.superresolution.ldm_upsample.proj'),
        'dit2': convert_dit2(sd, dit2_depth,
                             prefix=f'{p}decoder.vit_decoder.'),
        'conv_sr': convert_sd_decoder(
            sd, ch_mult=dec_ch_mult, num_res_blocks=num_res_blocks,
            prefix=f'{p}decoder.superresolution.conv_sr.'),
        'osg_decoder': convert_osg_decoder(
            sd, prefix=f'{p}decoder.triplane_decoder.decoder.net'),
    }


def convert_joint_objaverse(sd: Mapping, dit_depth: int = 24,
                            dit2_depth: int = 24,
                            denoiser_variant: str = 'text',
                            **vae_kwargs) -> dict:
    """Split + convert a full reference joint checkpoint.  Returns
    ``{'denoiser': ..., 'vae': ..., 'mixing_logit': ...}`` (the DiT
    denoisers store ``mixing_logit`` as a top-level ddpm buffer)."""
    subs = split_joint_checkpoint(sd)
    ddpm, rec = subs['ddpm_model'], subs['rec_model']
    out = {
        'denoiser': convert_dit_trilatent(ddpm, depth=dit_depth,
                                          variant=denoiser_variant),
        'vae': convert_vae_objaverse(rec, dit2_depth=dit2_depth,
                                     **vae_kwargs),
    }
    if 'mixing_logit' in ddpm:
        out['mixing_logit'] = _np(ddpm['mixing_logit'])
    return out


def convert_joint_shapenet(sd: Mapping, unet_cfg,
                           fusion_depth: int = 6,
                           encoder_depth: int = 12) -> dict:
    """ShapeNet release joint checkpoint: LDM U-Net denoiser (+LSGM
    mixing logit inside the U-Net params) + fusionv5 VAE."""
    subs = split_joint_checkpoint(sd)
    return {
        'denoiser': convert_unet(subs['ddpm_model'], unet_cfg),
        'vae': convert_vae_shapenet(subs['rec_model'],
                                    fusion_depth=fusion_depth,
                                    encoder_depth=encoder_depth),
    }


def convert_mapping_network(sd: Mapping, num_layers: int = 8,
                            prefix: str = '') -> dict:
    """StyleGAN2 MappingNetwork (``nsr/networks_stylegan2.py:246``):
    fc{i}.weight (O, I) → EqualDense kernels (I, O); tracked w_avg goes
    to the 'stats' collection (returned under '_w_avg')."""
    p = prefix
    out = {}
    for i in range(num_layers):
        out[f'fc{i}'] = {
            'kernel': np.transpose(_np(sd[f'{p}fc{i}.weight']), (1, 0)),
            'bias': _np(sd[f'{p}fc{i}.bias']),
        }
    if f'{p}embed.weight' in sd:
        out['embed'] = {
            'kernel': np.transpose(_np(sd[f'{p}embed.weight']), (1, 0)),
            'bias': _np(sd[f'{p}embed.bias']),
        }
    if f'{p}w_avg' in sd:
        out['_w_avg'] = _np(sd[f'{p}w_avg'])
    return out


def convert_eg3d_generator(sd: Mapping, prefix: str = 'G_ema.'):
    """Reference EG3D ``TriPlaneGenerator`` (``nsr/triplane.py:29-300``:
    ``backbone`` = StyleGAN2 mapping+synthesis, ``decoder`` = OSG) →
    our ``models/eg3d.py`` trees.  Input: the flat torch-named dict a
    legacy ``.pkl`` yields via ``utils/legacy_pkl.legacy_pkl_to_npz``
    (default net key ``G_ema``).  Returns ``(params, stats)`` — the
    tracked ``w_avg`` goes to ``stats['mapping']`` (truncation ψ<1
    reads it at apply time).

    Note the documented per-block-w deviation (``models/eg3d.py``): our
    blocks consume one w per block; with a single (non-style-mixed) w
    the mapping broadcasts identical rows, so conversion is faithful for
    the warm-up teacher use (ψ applies uniformly without a cutoff).
    """
    p = prefix
    syn = f'{p}backbone.synthesis.'
    # torch const is (C, H, W) → ours (H, W, C)
    params_syn = {
        'const': _np(sd[f'{syn}b4.const']).transpose(1, 2, 0),
        'b4_conv1': _sg2_layer(sd, f'{syn}b4.conv1'),
        'b4_torgb': _sg2_layer(sd, f'{syn}b4.torgb', torgb=True),
    }
    res = 8
    while f'{syn}b{res}.conv0.weight' in sd:
        params_syn[f'b{res}'] = {
            'conv0': _sg2_layer(sd, f'{syn}b{res}.conv0'),
            'conv1': _sg2_layer(sd, f'{syn}b{res}.conv1'),
            'torgb': _sg2_layer(sd, f'{syn}b{res}.torgb', torgb=True),
        }
        res *= 2
    mp = f'{p}backbone.mapping.'
    num_layers = sum(1 for k in sd
                     if k.startswith(f'{mp}fc') and k.endswith('.weight'))
    mapping = convert_mapping_network(sd, num_layers=num_layers, prefix=mp)
    w_avg = mapping.pop('_w_avg', None)
    params = {
        'synthesis': params_syn,
        'mapping': mapping,
        'decoder': convert_osg_decoder(sd, prefix=f'{p}decoder.net'),
    }
    stats = {'mapping': {'w_avg': w_avg}} if w_avg is not None else {}
    return params, stats


def convert_stylegan3_synthesis(sd: Mapping, prefix: str = ''):
    """StyleGAN3 ``SynthesisNetwork`` (``nsr/networks_stylegan3.py:517``)
    → our ``SynthesisNetworkSG3`` trees.

    Layer modules are discovered from the ``L{idx}_{size}_{ch}`` key
    prefixes (the JAX submodules use the identical naming scheme).
    Returns ``(params, stats)``: the Fourier ``freqs``/``phases``/
    ``transform`` buffers and per-layer ``magnitude_ema`` go to the
    ``'stats'`` collection.
    """
    p = prefix
    params = {'input': {
        'weight': _np(sd[f'{p}input.weight']),
        'affine_kernel': np.transpose(_np(sd[f'{p}input.affine.weight']),
                                      (1, 0)),
        'affine_bias': _np(sd[f'{p}input.affine.bias']),
    }}
    stats = {'input': {
        'freqs': _np(sd[f'{p}input.freqs']),
        'phases': _np(sd[f'{p}input.phases']),
        'transform': _np(sd[f'{p}input.transform']),
    }}
    names = sorted({k[len(p):].split('.')[0] for k in sd
                    if k.startswith(f'{p}L')},
                   key=lambda n: int(n[1:].split('_')[0]))
    for name in names:
        q = f'{p}{name}'
        params[name] = {
            'affine': {
                'kernel': np.transpose(_np(sd[f'{q}.affine.weight']),
                                       (1, 0)),
                'bias': _np(sd[f'{q}.affine.bias']),
            },
            # (Co, Ci, kh, kw) → (kh, kw, Ci, Co)
            'weight': np.transpose(_np(sd[f'{q}.weight']), (2, 3, 1, 0)),
            'bias': _np(sd[f'{q}.bias']),
        }
        stats[name] = {'magnitude_ema': _np(sd[f'{q}.magnitude_ema'])}
    return params, stats
