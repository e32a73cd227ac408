"""PyTorch / CUDA port of ``ln3diff_tpu`` for NVIDIA Hopper cards.

The package mirrors the JAX package's module names so each counterpart is
easy to find (``ln3diff_tpu_torch/render/renderer.py`` ↔
``ln3diff_tpu/render/renderer.py``).  It imports torch, numpy and the
standard library only — never JAX, its Linen layers or the JAX package —
so it runs on a machine that has none of them.

Ported so far: the text→3D serving path (CLIP text tower → DiT-L/2 DDIM
with classifier-free guidance → triplane VAE decode → orbit render and
σ-grid query) and its one TPU kernel, the fused triplane point pipeline
(``ops/fused_render.py``, CUDA source in ``ops/csrc/fused_osg.cu``).

Entry points (:class:`~ln3diff_tpu_torch.pipeline.TextTo3DPipeline`,
:func:`~ln3diff_tpu_torch.pipeline.build_t23d_pipeline`) run on the CUDA
device unless the caller passes ``device='cpu'``.
"""
