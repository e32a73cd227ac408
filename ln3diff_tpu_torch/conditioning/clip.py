"""CLIP text and vision towers (HF ``openai/clip-vit-large-patch14``) and
the CLIP byte-level BPE tokenizer.

Port of ``ln3diff_tpu/conditioning/clip.py`` (``quick_gelu`` :28,
``CLIPTextConfig`` :33, ``CLIPVisionConfig`` :45, ``CLIPMLP`` …
``CLIPTextModel`` :56-136, ``CLIPVisionModel`` :137, ``bytes_to_unicode``
… ``default_tokenizer`` :183-347): pre-LN transformers with quick-GELU.
The text tower is causal and returns ``last_hidden_state`` (B, 77, 768),
the EOT-pooled feature and, with ``with_projection``, its bias-free
``text_projection`` (``text_embeds``, the ShapeNet/FFHQ conditioning);
the vision tower returns its tokens (B, 257, 1024), the post-LayerNormed
class token and, on request, every layer's tokens.
``pooled_text_context`` (:349) turns ``text_embeds`` into the ShapeNet/FFHQ
cross-attention context.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.layers import dot_product_attention


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_length: int = 77
    intermediate_size: int = 3072
    with_projection: bool = False     # OpenAI encode_text text_projection
    # the dtype the pipeline builders store the tower in (JAX: its
    # compute dtype), as ``ViTConfig.dtype``
    dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    # as ``CLIPTextConfig.dtype``
    dtype: Any = torch.float32


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, intermediate)
        self.fc2 = nn.Linear(intermediate, dim)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, causal: bool):
        B, L, D = x.shape

        def split(t):
            return t.reshape(B, L, self.num_heads, D // self.num_heads)

        out = dot_product_attention(split(self.q_proj(x)),
                                    split(self.k_proj(x)),
                                    split(self.v_proj(x)), is_causal=causal)
        return self.out_proj(out.reshape(B, L, D))


class CLIPLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = CLIPAttention(dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = CLIPMLP(dim, intermediate)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.randn(cfg.max_length, cfg.hidden_size) * 0.01)
        self.layers = nn.ModuleList([
            CLIPLayer(cfg.hidden_size, cfg.num_heads, cfg.intermediate_size)
            for _ in range(cfg.num_layers)])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        if cfg.with_projection:
            self.text_projection = nn.Linear(cfg.hidden_size,
                                             cfg.hidden_size, bias=False)

    def forward(self, input_ids: torch.Tensor) -> dict:
        """input_ids (B, L) int → last_hidden_state (B, L, D), pooler_output
        (B, D) at the EOT token (the highest id) and, with
        ``with_projection``, text_embeds (B, D)."""
        B, L = input_ids.shape
        input_ids = input_ids.long()
        x = self.token_embedding(input_ids)
        x = x + self.position_embedding[None, :L].to(x.dtype)
        for layer in self.layers:
            x = layer(x, causal=True)
        x = self.final_layer_norm(x)
        eot = torch.argmax(input_ids, dim=-1)
        pooled = x[torch.arange(B, device=x.device), eot]
        out = {'last_hidden_state': x, 'pooler_output': pooled}
        if self.cfg.with_projection:
            out['text_embeds'] = self.text_projection(pooled)
        return out


def pooled_text_context(pooled: torch.Tensor, n_repeat: int = 1,
                        normalize: bool = True,
                        scale_clip_encoding: Optional[float] = None
                        ) -> torch.Tensor:
    """The ShapeNet/FFHQ text→3D context (reference
    ``FrozenCLIPTextEmbedder.encode``): the pooled CLIP text feature (B, D),
    L2-normalised and scaled by ``scale_clip_encoding``, repeated
    ``n_repeat`` times → (B, n_repeat, D).  The reference applies the scale
    only under normalisation, so a scale without ``normalize`` raises."""
    if not normalize and scale_clip_encoding is not None:
        raise ValueError('scale_clip_encoding requires normalize=True '
                         '(the reference nests the scale under the '
                         'normalisation)')
    z = pooled
    if normalize:
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        if scale_clip_encoding is not None:
            z = z * scale_clip_encoding
    return z[:, None, :].expand(z.shape[0], n_repeat, z.shape[-1])


class CLIPVisionModel(nn.Module):
    """``in_channels``: 3, or 6 for the vision-aided discriminator's SR
    variant (rgb + raw)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 in_channels: int = 3):
        super().__init__()
        self.cfg = cfg
        D, p = cfg.hidden_size, cfg.patch_size
        self.patch_embedding = nn.Conv2d(in_channels, D, p, stride=p,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.randn(D) * 0.02)
        n_pos = (cfg.image_size // p)**2 + 1
        self.position_embedding = nn.Parameter(torch.randn(n_pos, D) * 0.02)
        self.pre_layrnorm = nn.LayerNorm(D, eps=1e-5)
        self.layers = nn.ModuleList([
            CLIPLayer(D, cfg.num_heads, cfg.intermediate_size)
            for _ in range(cfg.num_layers)])
        self.post_layernorm = nn.LayerNorm(D, eps=1e-5)

    def forward(self, pixel_values: torch.Tensor,
                output_hidden_states: bool = False) -> dict:
        """pixel_values (B, H, W, 3) channels-last, CLIP-normalised →
        ``tokens`` (B, 1 + L, D) after the last layer, ``pooler_output``
        (B, D), the post-LayerNormed class token, and with
        ``output_hidden_states`` the tuple of every layer's tokens."""
        B = pixel_values.shape[0]
        dtype = self.patch_embedding.weight.dtype
        x = self.patch_embedding(pixel_values.to(dtype).permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding[None].to(x.dtype)
        x = self.pre_layrnorm(x)
        hidden = []
        for layer in self.layers:
            x = layer(x, causal=False)
            if output_hidden_states:
                hidden.append(x)
        out = {'tokens': x, 'pooler_output': self.post_layernorm(x[:, 0])}
        if output_hidden_states:
            out['hidden_states'] = tuple(hidden)
        return out


# -- byte-level BPE tokenizer ----------------------------------------------

def bytes_to_unicode() -> dict:
    """GPT-2/CLIP reversible byte → unicode map."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('¡'), ord('¬') + 1))
          + list(range(ord('®'), ord('ÿ') + 1)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _split_words(text: str) -> list[str]:
    """CLIP's pre-tokenisation split (the ``regex`` package's pattern, or
    an ASCII approximation without it)."""
    try:
        import regex
    except ImportError:
        import re
        return re.compile(
            r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE).findall(text)
    return regex.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", regex.IGNORECASE).findall(text)


class SimpleCLIPTokenizer:
    """CLIP byte-level BPE tokenizer.

    With ``bpe_path`` (``bpe_simple_vocab_16e6.txt[.gz]``) this is the full
    CLIP tokenizer (49408 ids, ``<|startoftext|>`` 49406,
    ``<|endoftext|>`` 49407).  Without it, a hash-bucket fallback —
    ``hash(word) % 49000 + 320`` — stands in, as in the JAX package; it is
    not CLIP-compatible, and Python's string hash changes between
    processes unless ``PYTHONHASHSEED`` is set.
    """

    def __init__(self, bpe_path: Optional[str] = None,
                 max_length: int = 77, num_merges: int = 48894):
        self.max_length = max_length
        self.sot, self.eot = 49406, 49407
        self.bpe_path = bpe_path
        self._real = bpe_path is not None
        if self._real:
            self._load_merges(bpe_path, num_merges)

    def _load_merges(self, path: str, num_merges: int):
        import gzip
        opener = gzip.open if path.endswith('.gz') else open
        with opener(path, 'rt', encoding='utf-8') as f:
            lines = f.read().split('\n')
        merges = [tuple(line.split()) for line in
                  lines[1:num_merges + 1] if line.strip()]
        self.byte_encoder = bytes_to_unicode()
        chars = list(self.byte_encoder.values())
        vocab = chars + [c + '</w>' for c in chars]
        vocab += [''.join(m) for m in merges]
        vocab += ['<|startoftext|>', '<|endoftext|>']
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder['<|startoftext|>']
        self.eot = self.encoder['<|endoftext|>']
        self._cache = {}

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        parts = list(token[:-1]) + [token[-1] + '</w>']
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, 1 << 30))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if (i < len(parts) - 1
                        and (parts[i], parts[i + 1]) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def encode(self, text: str) -> list[int]:
        """Token ids without specials or padding."""
        import html
        text = html.unescape(html.unescape(text))
        text = ' '.join(text.split()).strip().lower()
        if not self._real:
            return [hash(w) % 49000 + 320 for w in text.split()]
        ids = []
        for word in _split_words(text):
            enc = ''.join(self.byte_encoder[b] for b in word.encode('utf-8'))
            ids.extend(self.encoder[t] for t in self._bpe(enc))
        return ids

    def __call__(self, texts: list[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.max_length), np.int32)
        for i, t in enumerate(texts):
            ids = ([self.sot] + self.encode(t)[:self.max_length - 2]
                   + [self.eot])
            out[i, :len(ids)] = ids
        return out


def default_tokenizer(bpe_path: Optional[str] = None,
                      max_length: int = 77) -> SimpleCLIPTokenizer:
    """Explicit path → ``$LN3DIFF_CLIP_BPE`` → the repository's
    ``assets/bpe_simple_vocab_16e6.txt[.gz]`` → hash-bucket fallback (with
    a warning)."""
    import os
    path = bpe_path or os.environ.get('LN3DIFF_CLIP_BPE')
    if not path:
        repo = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        for cand in ('assets/bpe_simple_vocab_16e6.txt.gz',
                     'assets/bpe_simple_vocab_16e6.txt'):
            p = os.path.join(repo, cand)
            if os.path.exists(p):
                path = p
                break
    tok = SimpleCLIPTokenizer(bpe_path=path or None, max_length=max_length)
    if not tok._real:
        import warnings
        warnings.warn(
            'CLIP BPE merges file not found — tokenizer is running the '
            'HASH-BUCKET fallback (fine for random-init runs, garbage with '
            'converted CLIP weights). Drop bpe_simple_vocab_16e6.txt[.gz] '
            'into assets/ or set $LN3DIFF_CLIP_BPE.', RuntimeWarning,
            stacklevel=2)
    return tok
