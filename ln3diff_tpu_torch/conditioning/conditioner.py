"""GeneralConditioner: embedder list with classifier-free dropout.

Port of ``ln3diff_tpu/conditioning/conditioner.py`` (``Embedder`` :23,
``GeneralConditioner`` :42, ``make_clip_text_embedder`` :91,
``make_clip_image_embedder`` :121, ``make_dino_embedder`` :150,
``make_dino_mv_embedder`` :171, ``make_dino_mv_plucker_embedder`` :202 and
``make_concat_timestep_embedder`` :249): each embedder declares its input key,
its output keys (crossattn / vector / dino) and its ucg (unconditional
guidance dropout) rate; ``get_unconditional_conditioning`` gives the
(c, uc) pair the samplers take.  The embedders wrap the port's torch
modules where the JAX ones take parameter trees; the image→3D and
multi-view→3D builders run their towers through them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Embedder:
    """One conditioning tower.

    encode: (batch_inputs) -> dict of output_key → tensor.
    uncond: (n) -> the same-structure dict for the null conditioning
    ('' caption / zero image).
    ucg_rate: probability of dropping a sample to its unconditional value
    during training (reference ucg_rate 0.1).
    is_trainable: whether the tower trains with the denoiser (the
    reference's flag; every released tower is frozen).
    """
    input_key: str
    encode: Callable[[Any], dict]
    uncond: Callable[[int], dict]
    ucg_rate: float = 0.0
    is_trainable: bool = False
    name: str = ''


class GeneralConditioner:
    def __init__(self, embedders: list[Embedder]):
        self.embedders = embedders

    def __call__(self, batch: dict, rng: Optional[np.random.Generator] = None,
                 force_uncond: bool = False) -> dict:
        """Encode the batch into a context dict, dropping samples to the
        unconditional value with each embedder's ucg rate when an ``rng``
        is given (training).  'vector' outputs concatenate along the last
        axis, the others along the token axis."""
        out: dict = {}
        for emb in self.embedders:
            if emb.input_key not in batch and not force_uncond:
                continue
            if force_uncond:
                enc = emb.uncond(len(batch[next(iter(batch))]))
            else:
                enc = emb.encode(batch[emb.input_key])
                if rng is not None and emb.ucg_rate > 0:
                    n = next(iter(enc.values())).shape[0]
                    drop = torch.from_numpy(rng.random(n) < emb.ucg_rate)
                    null = emb.uncond(n)
                    enc = {k: torch.where(
                        drop.to(v.device).reshape((-1,) + (1,) * (v.ndim - 1)),
                        null[k].to(v.device), v) for k, v in enc.items()}
            for k, v in enc.items():
                if k in out:
                    out[k] = torch.cat([out[k], v],
                                       dim=-1 if k == 'vector' else 1)
                else:
                    out[k] = v
        return out

    def get_unconditional_conditioning(self, batch: dict):
        """(c, uc) pair (reference ``get_unconditional_conditioning``); for a
        key that several embedders give, uc holds the first one's."""
        c = self(batch)
        n = next(iter(c.values())).shape[0]
        uc: dict = {}
        for emb in self.embedders:
            for k, v in emb.uncond(n).items():
                uc.setdefault(k, v)
        return c, uc


def _device_of(module):
    return next(module.parameters()).device


def make_clip_text_embedder(text_model, tokenizer=None,
                            ucg_rate: float = 0.1,
                            always_return_pooled: bool = True) -> Embedder:
    """FrozenCLIPEmbedder: captions → crossattn tokens (+ pooled vector),
    from the port's ``CLIPTextModel``."""
    from .clip import default_tokenizer

    tokenizer = tokenizer or default_tokenizer()

    @torch.no_grad()
    def encode(captions):
        ids = torch.as_tensor(tokenizer(list(captions)),
                              device=_device_of(text_model))
        out = text_model(ids)
        enc = {'crossattn': out['last_hidden_state']}
        if always_return_pooled:
            enc['vector'] = out['pooler_output']
        return enc

    def uncond(n):
        return encode([''] * n)

    return Embedder(input_key='caption', encode=encode, uncond=uncond,
                    ucg_rate=ucg_rate, name='clip_text')


def make_clip_image_embedder(vision_model, ucg_rate: float = 0.1
                             ) -> Embedder:
    """FrozenOpenCLIPImageEmbedder(output_tokens): images (B, H, W, 3) →
    crossattn spatial tokens (1024) + pooled vector, from the port's
    ``CLIPVisionModel``; the null conditioning is zeros."""

    @torch.no_grad()
    def encode(images):
        out = vision_model(torch.as_tensor(
            images, device=_device_of(vision_model)))
        return {'crossattn': out['tokens'], 'vector': out['pooler_output']}

    def uncond(n):
        hw = vision_model.cfg.image_size
        enc = encode(torch.zeros((n, hw, hw, 3)))
        return {k: torch.zeros_like(v) for k, v in enc.items()}

    return Embedder(input_key='img', encode=encode, uncond=uncond,
                    ucg_rate=ucg_rate, name='clip_image')


def make_dino_embedder(vit_model, ucg_rate: float = 0.1) -> Embedder:
    """FrozenDinov2ImageEmbedder: images → 'dino' spatial tokens for the
    image→3D self-attention concat, from the port's
    ``VisionTransformer``; the null conditioning is zeros."""

    @torch.no_grad()
    def encode(images):
        return {'dino': vit_model(torch.as_tensor(
            images, device=_device_of(vit_model)))}

    def uncond(n):
        hw = vit_model.cfg.img_size
        tokens = encode(torch.zeros((n, hw, hw, 3)))['dino']
        return {'dino': torch.zeros_like(tokens)}

    return Embedder(input_key='img', encode=encode, uncond=uncond,
                    ucg_rate=ucg_rate, name='dino')


def make_dino_mv_embedder(vit_model, ucg_rate: float = 0.0,
                          n_cond_frames: int = 4) -> Embedder:
    """FrozenDinov2ImageEmbedderMV (reference
    ``sgm/modules/encoders/modules.py:1185``): images (B, V, H, W, 3) →
    the first ``n_cond_frames`` views' DINOv2 tokens flattened across
    views, (B, V·L, D) on 'dino'.  As in the JAX package, the reference's
    camera modulation of the DINO blocks is left out."""
    hw = vit_model.cfg.img_size

    @torch.no_grad()
    def encode(images):
        images = torch.as_tensor(images, device=_device_of(vit_model))
        B, V = images.shape[:2]
        V = min(V, n_cond_frames)
        tokens = vit_model(images[:, :V].reshape(B * V, hw, hw, 3))
        L, D = tokens.shape[1:]
        return {'dino': tokens.reshape(B, V * L, D)}

    def uncond(n):
        tokens = encode(torch.zeros((n, n_cond_frames, hw, hw, 3)))['dino']
        return {'dino': torch.zeros_like(tokens)}

    return Embedder(input_key='img', encode=encode, uncond=uncond,
                    ucg_rate=ucg_rate, name='dino_mv')


def make_dino_mv_plucker_embedder(vit_model, ucg_rate: float = 0.0,
                                  n_cond_frames: int = 4) -> Embedder:
    """FrozenDinov2ImageEmbedderMVPlucker (reference
    ``sgm/modules/encoders/modules.py:871-1014``): the first
    ``n_cond_frames`` views with their 25-dim cameras → per-view Plücker
    ray maps [cross(o, d), d] concatenated onto RGB → the port's
    ``VisionTransformer(cfg, in_channels=9)`` → tokens flattened
    across views, (B, V·L, D) on 'dino'.  ``encode`` takes ``(images,
    cameras)``: (B, V, H, W, 3) in [-1, 1] and (B, V, 25).  The null
    conditioning is zeros."""
    from ..data.objaverse import plucker_embedding
    hw = vit_model.cfg.img_size

    @torch.no_grad()
    def encode(img_c):
        images, cameras = (np.asarray(a) for a in img_c)
        B, V = images.shape[:2]
        V = min(V, n_cond_frames)
        plucker = np.stack([
            np.stack([plucker_embedding(cameras[b, v], hw)
                      for v in range(V)]) for b in range(B)])
        x = np.concatenate([images[:, :V], plucker], axis=-1)
        tokens = vit_model(torch.as_tensor(
            x.reshape(B * V, hw, hw, 9), device=_device_of(vit_model)))
        L, D = tokens.shape[1:]
        return {'dino': tokens.reshape(B, V * L, D)}

    @torch.no_grad()
    def uncond(n):
        tokens = vit_model(torch.zeros((n * n_cond_frames, hw, hw, 9),
                                       device=_device_of(vit_model)))
        L, D = tokens.shape[1:]
        return {'dino': torch.zeros((n, n_cond_frames * L, D),
                                    dtype=tokens.dtype,
                                    device=tokens.device)}

    return Embedder(input_key='img-c', encode=encode, uncond=uncond,
                    ucg_rate=ucg_rate, name='dino_mv_plucker')


def make_concat_timestep_embedder(outdim: int = 256,
                                  input_key: str = 'original_size_as_tuple',
                                  ucg_rate: float = 0.0, n_dims: int = 2,
                                  device='cuda') -> Embedder:
    """ConcatTimestepEmbedderND (reference
    ``sgm/modules/encoders/modules.py:1516``): each scalar of a size or
    crop tuple (B, d) through the sinusoidal table, concatenated to
    (B, d·outdim) on 'vector'.  No parameters.  The unconditional value is
    the embedding of an all-zero tuple of ``n_dims``, as in JAX."""
    from ..models.layers import timestep_embedding

    def encode_vals(x):
        x = torch.as_tensor(x, device=device)
        if x.ndim == 1:
            x = x[:, None]
        b, d = x.shape
        return timestep_embedding(x.reshape(-1), outdim).reshape(b, d * outdim)

    def encode(x):
        return {'vector': encode_vals(x)}

    def uncond(n):
        return {'vector': encode_vals(torch.zeros((n, n_dims)))}

    return Embedder(input_key=input_key, encode=encode, uncond=uncond,
                    ucg_rate=ucg_rate, name='concat_timestep')
