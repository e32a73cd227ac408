"""ln3diff_tpu_torch — the PyTorch / CUDA port of ``ln3diff_tpu`` for
NVIDIA Hopper cards: two-stage text-, image- and multi-view→3D latent
diffusion.

The package mirrors the JAX package's module names so each counterpart is
easy to find (``ln3diff_tpu_torch/render/renderer.py`` ↔
``ln3diff_tpu/render/renderer.py``).  It imports torch, numpy and the
standard library only — never JAX, its Linen layers or the JAX package —
so it runs on a machine that has none of them.

What it holds:

* serving — the text→3D, image→3D and multi-view→3D calls of the
  Objaverse releases and the ShapeNet and FFHQ text→3D calls
  (``pipeline.py``: DDIM, PLMS, DPM-Solver++, the flow-matching ODE; bf16
  or W8A8 int8 denoisers; orbit render, σ grid and mesh), also split over
  several ranks (``parallel/serving.py``);
* training — the stage-1 VAE (also adversarially), the stage-2 DiT and
  ControlNet, the LSGM joint trainer and the EG3D warm-up, on one device
  or under data, FSDP and pipeline parallelism (``training/``,
  ``parallel/``), fed from memory or from tar shards (``data/``);
* the entry points under ``scripts/`` (training, sampling, checkpoint
  conversion, the data tools, the evaluator, the two-stage and image→3D
  demos) and the console scripts of ``cli.py``;
* evaluation (``evaluation/``: the FID InceptionV3, FID / sFID / IS /
  precision and recall), the sgm yaml configs (``sgm_config.py``) and
  profiling (``utils/profiling.py``);
* the four TPU kernels as hand-written CUDA sources in ``ops/csrc/``: the
  fused triplane point pipeline (``fused_osg.cu``) and its backward
  (``fused_osg_bwd.cu``) behind ``ops/fused_render.py``, the fused
  self-attention (``fused_attention.cu``) and the fused qkv projection +
  attention (``fused_qkv_attention.cu``) behind ``ops/fused_attention.py``.

Entry points run on the CUDA device unless the caller passes
``device='cpu'``.  The top-level surface is lazy — submodules import on
first attribute access:

    >>> import ln3diff_tpu_torch as l3
    >>> cfg = l3.release_preset('objaverse/t23d-dit')
    >>> vae = l3.TriplaneVAE(l3.vae_preset('objaverse'))
"""

from __future__ import annotations

import importlib

__version__ = '0.2.0'

# public name → defining submodule (the JAX package's names), resolved on
# first access so that importing the package imports no submodule
_EXPORTS = {
    'TextTo3DPipeline': 'ln3diff_tpu_torch.pipeline',
    'SamplerSpec': 'ln3diff_tpu_torch.pipeline',
    'TriplaneVAE': 'ln3diff_tpu_torch.models.vae',
    'DiT_TriLatent': 'ln3diff_tpu_torch.models.dit',
    'UNetModel': 'ln3diff_tpu_torch.models.unet',
    'make_diffusion': 'ln3diff_tpu_torch.diffusion.gaussian',
    'release_preset': 'ln3diff_tpu_torch.config',
    'vae_preset': 'ln3diff_tpu_torch.config',
    'denoiser_preset': 'ln3diff_tpu_torch.config',
    'RENDER_PRESETS': 'ln3diff_tpu_torch.config',
    'RELEASE_PRESETS': 'ln3diff_tpu_torch.config',
    'make_mesh': 'ln3diff_tpu_torch.parallel.mesh',
    # serving: int8 quantization + multi-rank render/sampling sharding
    'quantize_dit': 'ln3diff_tpu_torch.ops.int8',
    'quantize_unet': 'ln3diff_tpu_torch.ops.int8',
    'shard_orbit_render': 'ln3diff_tpu_torch.parallel.serving',
    'shard_points_query': 'ln3diff_tpu_torch.parallel.serving',
    'tp_shard_denoiser_params': 'ln3diff_tpu_torch.parallel.serving',
}

__all__ = sorted(_EXPORTS) + ['__version__']


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f'module {__name__!r} has no attribute '
                             f'{name!r}')
    return getattr(importlib.import_module(mod), name)


def __dir__():
    return __all__
