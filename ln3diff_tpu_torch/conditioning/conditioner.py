"""GeneralConditioner: embedder list with classifier-free dropout.

Port of ``ln3diff_tpu/conditioning/conditioner.py`` (``Embedder`` :23,
``GeneralConditioner`` :42, ``make_clip_text_embedder`` :91,
``make_clip_image_embedder`` :121, ``make_dino_embedder`` :150 and
``make_dino_mv_embedder`` :171): each embedder declares its input key,
its output keys (crossattn / vector / dino) and its ucg (unconditional
guidance dropout) rate; ``get_unconditional_conditioning`` gives the
(c, uc) pair the samplers take.  The embedders wrap the port's torch
modules where the JAX ones take parameter trees; the image→3D and
multi-view→3D builders run their towers through them.  The Plücker multi-view
embedder and the concat-timestep embedder are not ported.
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
    """
    input_key: str
    encode: Callable[[Any], dict]
    uncond: Callable[[int], dict]
    ucg_rate: float = 0.0
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
