"""PyTorch / CUDA port of ``ln3diff_tpu`` for NVIDIA Hopper cards.

The package mirrors the JAX package's module names so each counterpart is
easy to find (``ln3diff_tpu_torch/render/renderer.py`` ↔
``ln3diff_tpu/render/renderer.py``).  It imports torch, numpy and the
standard library only — never JAX, its Linen layers or the JAX package —
so it runs on a machine that has none of them.

Ported so far: the text→3D serving call (CLIP text tower → DiT-L/2 DDIM
with classifier-free guidance → triplane VAE decode → orbit render, σ-grid
query and mesh file), the image→3D and multi-view→3D calls, the ShapeNet
and FFHQ text→3D calls (pooled CLIP text → U-Net-320 LSGM → fusion-decoder
VAEs → orbit through a render-space SR head), the stage-1 VAE training
step on one device, and all
four TPU kernels as CUDA sources in ``ops/csrc/``: the fused triplane point
pipeline (``fused_osg.cu``) and its backward (``fused_osg_bwd.cu``), both
behind ``ops/fused_render.py``; the fused self-attention
(``fused_attention.cu``) and the fused qkv projection + attention
(``fused_qkv_attention.cu``, which runs the former's device code from
``attention_common.cuh`` over its projection), both behind
``ops/fused_attention.py``.

Entry points (:class:`~ln3diff_tpu_torch.pipeline.TextTo3DPipeline` and
the ``build_*_pipeline`` functions of ``pipeline.py``) run on the CUDA
device unless the caller passes ``device='cpu'``.
"""
