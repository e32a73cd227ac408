"""Generative metrics: FID, sFID, Inception Score, Precision & Recall.

Port of ``ln3diff_tpu/evaluation/metrics.py`` (``_sqrtm_psd`` :31,
``frechet_distance`` :38, ``feature_statistics`` :57, ``compute_fid`` :63,
``inception_score`` :72, ``_softmax`` :88, ``_pairwise_d2`` :97,
``precision_recall`` :108, ``EvalResult`` :139,
``make_clip_feature_fn`` :151, ``make_inception_feature_fn`` :191,
``evaluate_npz`` :247; reference ``evaluations/evaluator.py:27-653``).
The metric math is numpy, copied line for line, so that the same
features give the JAX package's numbers bit for bit.  The feature
extractors run the port's torch modules:

  * the reference protocol — the FID InceptionV3's pool3, its 1008
    logits and the ``mixed_6/conv`` spatial features
    (``evaluation/inception.py``), with the pytorch-fid weights when a
    state dict is given;
  * the narrow CLIP vision tower as a stand-in (random weights unless a
    state dict is given), whose FID values are extractor-relative.

Both switch TF32 off while they run (the FID network is declared f32) and
restore the flags after.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Fréchet distance
# ---------------------------------------------------------------------------

def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a PSD matrix via eigen-decomposition."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FID between two Gaussians (reference ``FIDStatistics.frechet_distance``
    / classic Heusel formulation)."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    offset = np.eye(sigma1.shape[0]) * eps
    s1 = sigma1 + offset
    s2 = sigma2 + offset
    # tr sqrt(s1 s2) = tr sqrt( sqrt(s1) s2 sqrt(s1) )  (symmetric PSD form)
    sq1 = _sqrtm_psd(s1)
    inner = sq1 @ s2 @ sq1
    covmean_tr = np.trace(_sqrtm_psd(inner))
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2 * covmean_tr)


def feature_statistics(feats: np.ndarray):
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def compute_fid(feats_ref: np.ndarray, feats_sample: np.ndarray) -> float:
    return frechet_distance(*feature_statistics(feats_ref),
                            *feature_statistics(feats_sample))


# ---------------------------------------------------------------------------
# Inception Score
# ---------------------------------------------------------------------------

def inception_score(logits: np.ndarray, splits: int = 10) -> float:
    """IS from classifier logits (reference ``compute_inception_score``)."""
    probs = _softmax(logits)
    scores = []
    n = probs.shape[0]
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        kl = part * (np.log(part + 1e-10)
                     - np.log(part.mean(axis=0, keepdims=True) + 1e-10))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores))


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Improved Precision & Recall (kNN manifolds)
# ---------------------------------------------------------------------------

def _pairwise_d2(a: np.ndarray, b: np.ndarray, block: int = 2048
                 ) -> np.ndarray:
    out = np.empty((a.shape[0], b.shape[0]), np.float32)
    bb = (b**2).sum(axis=1)
    for i in range(0, a.shape[0], block):
        aa = a[i:i + block]
        out[i:i + block] = ((aa**2).sum(1)[:, None] + bb[None]
                            - 2 * aa @ b.T)
    return np.maximum(out, 0)


def precision_recall(feats_ref: np.ndarray, feats_sample: np.ndarray,
                     nhood_size: int = 3):
    """Kynkäänniemi et al. improved P&R (reference ``ManifoldEstimator``).

    precision: fraction of samples within the ref manifold;
    recall: fraction of refs within the sample manifold.
    """
    def manifold_radii(feats):
        d2 = _pairwise_d2(feats, feats)
        np.fill_diagonal(d2, np.inf)
        return np.sort(d2, axis=1)[:, nhood_size - 1]

    r_ref = manifold_radii(feats_ref)
    r_smp = manifold_radii(feats_sample)

    d2_sr = _pairwise_d2(feats_sample, feats_ref)
    precision = float((d2_sr <= r_ref[None]).any(axis=1).mean())
    d2_rs = d2_sr.T
    recall = float((d2_rs <= r_smp[None]).any(axis=1).mean())
    return precision, recall


# ---------------------------------------------------------------------------
# evaluator protocol (npz batches, reference CLI semantics)
# ---------------------------------------------------------------------------

FeatureFn = Callable[[np.ndarray], tuple]
# images (N, H, W, 3) uint8 → (pool features (N, D), logits (N, K)
# [, spatial features (N, S)]) as numpy


@dataclasses.dataclass
class EvalResult:
    fid: float
    sfid: Optional[float]
    inception_score: float
    precision: float
    recall: float

    def __str__(self):
        sfid = 'n/a' if self.sfid is None else f'{self.sfid:.3f}'
        return (f'FID {self.fid:.3f} | sFID {sfid} | '
                f'IS {self.inception_score:.3f} | '
                f'P {self.precision:.3f} | R {self.recall:.3f}')


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block,
    the flags restored after (the extractors are f32 networks)."""
    import torch
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def _batched(images: np.ndarray, batch_size: int, fwd) -> tuple:
    """``fwd`` over chunks of ``batch_size`` images → the concatenated
    numpy outputs."""
    import torch
    outs = []
    with torch.no_grad(), no_tf32():
        for i in range(0, len(images), batch_size):
            outs.append([o.float().cpu().numpy()
                         for o in fwd(images[i:i + batch_size])])
    return tuple(np.concatenate(parts) for parts in zip(*outs))


def make_clip_feature_fn(batch_size: int = 32, state_dict=None,
                         device='cuda') -> FeatureFn:
    """CLIP-vision stand-in extractor → ``(pooled (N, 256), its first 64
    as logits, spatial (N, 512))``.  ``state_dict`` (the port's
    ``CLIPVisionModel`` names, e.g. through
    ``bridge.clip_vision_state_dict``) gives the weights; without one they
    are drawn from ``torch.Generator().manual_seed(0)`` (the JAX package
    draws from ``PRNGKey(0)``, which torch cannot replay)."""
    import torch
    import torch.nn.functional as F

    from ..conditioning.clip import CLIPVisionConfig, CLIPVisionModel
    from ..models.layers import random_init_
    from ..pipeline import resolve_device

    device = resolve_device(device)
    # the narrow tower: 224², patch 14, 256 wide, 4 layers (JAX :157-159)
    model = CLIPVisionModel(CLIPVisionConfig(
        image_size=224, patch_size=14, hidden_size=256, num_layers=4,
        num_heads=4, intermediate_size=512))
    if state_dict is None:
        random_init_(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    model = model.to(device).eval()

    def fwd(chunk):
        x = torch.as_tensor(chunk, device=device).float() / 127.5 - 1
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(224, 224),
                          mode='bilinear', align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
        out = model(x)
        # sFID analogue of Inception's mixed_6 spatial features: the first
        # 2 channels of every non-CLS token, flattened (512-dim at 16²
        # tokens) — sensitive to spatial layout where pooled FID is not.
        spatial = out['tokens'][:, 1:, :2].reshape(x.shape[0], -1)
        pooled = out['pooler_output']
        return pooled, pooled[:, :64], spatial

    def fn(images: np.ndarray):
        return _batched(images, batch_size, fwd)

    return fn


def make_inception_feature_fn(weights=None, batch_size: int = 32,
                              device='cuda') -> FeatureFn:
    """Reference-protocol extractor → ``(pool3 (N, 2048), logits (N,
    1008), spatial (N, 2023))``: the ``mixed_6/conv`` spatial features
    for sFID (``evaluations/evaluator.py:20-66``; the network in
    ``evaluation/inception.py``).

    ``weights``: a path to a torch state dict (pytorch-fid
    ``pt_inception-2015-12-05`` / torchvision layout, read with
    ``weights_only=True``) or a state dict; without one the weights are
    drawn from ``torch.Generator().manual_seed(0)`` (wall-clock identical,
    metric values not comparable until the weights are given)."""
    import torch

    from ..pipeline import resolve_device
    from .inception import InceptionV3, preprocess_uint8

    device = resolve_device(device)
    model = InceptionV3()
    if weights is None:
        from ..models.layers import random_init_
        random_init_(model, torch.Generator().manual_seed(0))
    else:
        sd = weights
        if isinstance(weights, (str, bytes)):
            sd = torch.load(weights, map_location='cpu', weights_only=True)
        if hasattr(sd, 'state_dict'):
            sd = sd.state_dict()
        model.load_state_dict(sd)
    model = model.to(device).eval()

    def fwd(chunk):
        out = model(preprocess_uint8(torch.as_tensor(chunk, device=device)))
        return out['pool3'], out['logits'], out['spatial']

    def fn(images: np.ndarray):
        return _batched(images, batch_size, fwd)

    return fn


def evaluate_npz(ref_npz: str, sample_npz: str,
                 feature_fn: Optional[FeatureFn] = None) -> EvalResult:
    """Reference CLI semantics: ``evaluator.py ref.npz sample.npz`` where
    each npz holds ``arr_0`` (N, H, W, 3) uint8."""
    feature_fn = feature_fn or make_clip_feature_fn()
    ref = np.load(ref_npz)['arr_0']
    smp = np.load(sample_npz)['arr_0']
    out_ref = feature_fn(ref)
    out_smp = feature_fn(smp)
    f_ref, logits = out_ref[0], out_smp[1]
    f_smp = out_smp[0]
    fid = compute_fid(f_ref, f_smp)
    sfid = None
    if len(out_ref) > 2:   # extractor provides spatial features
        sfid = compute_fid(out_ref[2], out_smp[2])
    is_score = inception_score(logits)
    p, r = precision_recall(f_ref, f_smp)
    return EvalResult(fid=fid, sfid=sfid, inception_score=is_score,
                      precision=p, recall=r)
