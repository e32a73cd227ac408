#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives these paths of ``ln3diff_tpu_torch`` at the full width of the
released Objaverse, ShapeNet and FFHQ models, with random weights drawn
from a fixed seed:

* ``pipeline``: CLIP text tower, DiT-L/2 with 250-step DDIM and CFG 6.5,
  triplane VAE decode, a 24-frame 192² orbit and the 192³ σ-grid query;
* ``serving_pipeline``: the full serving call ``__call__`` with a
  ``mesh_path`` and the fused-attention denoiser (``fused_attention=True``):
  the same stages, then marching tetrahedra, vertex colours and the OBJ
  file, interleaved with the orbit;
* ``vae_train``: training steps of the stage-1 VAE (``VAETrainer``: SD
  MVEncoder over 4 views of 256², DiT2-L/2 decoder, patch-32 renders with
  64+64 samples, AdamW, EMA) in bf16 over f32 parameters, with the point
  pipeline through the fused kernel and its backward kernel
  (``use_fused_osg=True``) and through plain PyTorch;
* ``qkv_attention_chain``: the fused qkv projection + attention (kernel 4)
  at the DiT-L/2 self-attention's shapes (B=2, L=768, D=1024, H=16, bf16)
  in the chain of ``.bench_megakernel.py``, x ← 0.5·y + 0.5·x for 1000
  steps, beside the same chain through library calls and 8 steps of the
  plain version;
* ``i23d_pipeline``: the image→3D serving call on one 224² image: CLIP
  ViT-L/14 vision tower (f32) and DINOv2-B/14 (bf16), DiT-I23D-L/2 with
  the DINO tokens in its self-attention (L = 1025), the flow-matching
  ODE with CFG 4.0, then the text→3D call's decode, orbit
  and mesh stages; with plain attention and with ``fused_attention=True``;
* ``mv23d_pipeline``: the multi-view→3D serving call on four views:
  DINOv2-B/14, DiT-PixArt-MV-L/2 with the views' tokens in its
  cross-attention, the same ODE and stages, plain and fused;
* ``t23d_samplers``: the text→3D serving call with 25 DPM-Solver++(2M)
  steps over the unspaced schedule (``bench.py``'s ``dpm25``) and with 25
  PLMS steps over ``ddim25``;
* ``t23d_int8``: the text→3D serving call with the W8A8 int8 DiT-L/2
  (``quantize_dit``), plain and fused attention, and a DDIM
  step of the int8 and bf16 denoisers under the profiler;
* ``i23d_int8``: the image→3D serving call with the int8 DiT-I23D-L/2;
* ``orbit_options``: ``__call__(cameras=...)`` on a pose file written
  with ``torch.save`` and read back with ``load_pose_asset``, and the
  orbit with the frames folded into the ray axis (``render_rays_fn`` with
  ``TriplaneVAE.render_rays_flat``) against the per-frame orbit;
* ``shapenet_pipeline``: the ShapeNet text→3D call (pooled CLIP-L text
  × 18.4, U-Net-320 LSGM with v-prediction and the mixing logit, DDIM
  at CFG 1.0, the fusionv5 VAE decode to 256² planes, a 24-frame orbit of
  64² rays with 64+64 samples and ``NearestConvSR`` to 128², the 192³ σ
  grid and the mesh);
* ``ffhq_pipeline``: the FFHQ call (pooled text × 1.0, the same U-Net at
  CFG 6.5, the 4XC_final VAE, 128² rays with 48+48 samples and
  ``SuperresolutionHybrid8XDC`` to 512², no mesh);
* ``unet_profile``: a DDIM step of the U-Net (batch 1 at CFG 1.0, batch 2
  CFG-doubled) under the profiler;
* ``shapenet_int8`` and ``ffhq_int8``: the two calls with the W8A8 int8
  U-Net-320 (``quantize_unet``: ``Int8Conv`` im2col over
  ``torch._int_mm``, ``Int8Linear``), and ``unet_int8_profile``: a DDIM
  step of the int8 and the bf16 U-Net under the profiler, and the int8
  conv beside cuDNN's bf16 conv at the first level's 3x3 shape;
* ``ffhq_fgbg_render``: the fg/bg VAE (``vae_preset('ffhq-fgbg')``: bf16
  decoder, 32 fg + 32 bg plane channels, NeRF++ background of 16 samples
  per ray, ``SuperresolutionHybrid`` ×4) decoding one latent and
  rendering a 24-frame orbit of 64² rays to 256², the fg pass through
  kernel 1 and through its plain version;
* ``ldm_train``: steps of the stage-2 trainer (``LDMTrainer``) of the
  text→3D DiT-L/2 with remat ``'dots'`` at batch 8, bf16 over f32
  parameters, with the DDPM objective of the t23d release and with flow
  matching, and the grads of a twin without remat; ``edm_sample``: the
  EDM Euler sampler through that DiT, 25 CFG steps;
  ``controlnet_train``: ``ControlNetTrainer`` over the U-Net-320, batch
  2, 256² hints, with the U-Net frozen;
* ``lsgm_train``: the LSGM joint trainer (``LSGMTrainer``) of the
  Objaverse VAE with the U-Net-320 (VPSDE p term, the q term through the
  frozen U-Net, one AdamW and EMA over both trees), bf16 over f32
  parameters, one instance; ``lsgm_checkpoint``: a train state through
  ``CheckpointManager`` and back;
* ``adv_vae_train``: the adversarial VAE trainer (``train/objaverse-vae``
  with ``use_fused_osg=True``, LPIPS and a 32² StyleGAN discriminator with
  R1): the generator step (kernels 1 and 2) and the discriminator step
  (its re-render through kernel 1), then a step with the vision-aided
  discriminator (CLIP ViT-B/32);
* ``eg3d_warmup``: the EG3D-distillation warm-up through its entry point
  (``python -m ln3diff_tpu_torch.training.eg3d_warmup``'s ``main``): the
  ``ffhq`` VAE (bf16 over f32 parameters) against the default EG3D
  ``TriPlaneGenerator`` teacher, batch 4, 64² renders with 48+48
  samples, a few steps and the final checkpoint, restored;
* ``lgm_encode``: the Objaverse VAE with the LGM multi-view U-Net
  encoder (``encoder_type='lgm'``) over 4 views of 256² × 10;
* ``stylegan3``: ``GeneratorSG3`` at its defaults (256², 14 layers),
  batch 4.  No kernel runs on these three paths (none does in JAX):
  each reads the four kernels' launch counters at 0;
* ``reference_checkpoint``: the ``objaverse/t23d-dit`` release's joint
  checkpoint (DiT-L/2 + the Objaverse VAE, about 1.03 B random f32
  values) under the reference's ``ddpm_model.*`` / ``rec_model.*`` names,
  as ``.safetensors`` and ``.pt``, each through the port's convert CLI
  with ``--verify``: 0 mismatches and the same converted bytes;
* ``sample_entry``: the port's sample CLI on that conversion with
  ``--preset objaverse/t23d-dit`` (DDIM 250, CFG 6.5, 24 frames of 128²,
  the 192³ mesh): 75 launches of kernel 1, the loaded weights bit for bit,
  frames, OBJ and AVI checked, then a small converted model card vs CPU;
* ``eg3d_teacher_pickle``: a persistence-format pickle of the default EG3D
  ``G_ema`` through ``legacy_pkl_to_npz`` into 2 warm-up steps of its
  entry point, the teacher's tensors and ``w_avg`` equal to the
  pickle's;
* under a one-rank NCCL process group (the parallel layer at world size
  1): ``parallel_vae_train``, the full-width VAE step with the kernel pair
  built with ``mesh=make_mesh()``, and again with its parameters held in
  the module as one-way shards (the FSDP path's gathers, reduce-scatters
  and saved-tensor recipes under NCCL), 3 steps of each equal to those of
  the same trainer without a mesh (deterministic algorithms), then 2 timed
  steps of each; ``train_entries``, the five
  training CLIs in process (``vit_triplane_train`` with a checkpoint, its
  resume and ``--inference``, ``vit_triplane_diffusion_train`` on the t23d
  DiT-L/2 preset and with ``--objective vpsde_joint``,
  ``vit_triplane_sit_train``, ``vit_triplane_cvD_train``,
  ``vit_triplane_cldm_train``) at the presets' widths with cut depths;
  ``serving_mesh``, the text→3D call with ``serving_mesh=make_mesh()``
  against the unsharded call on the same latents (75 launches of kernel
  1), and ``dit_pipeline_apply`` at pp = 1 with 4 microbatches on the
  DiT-L/2 against its plain forward;
* ``data_vae_train``: 8 synthetic instances of 8 views at 256² written
  into tar shards by the port's ``wds_create`` CLI, the native reader's
  samples against ``tarfile``'s, then the stream through
  ``PostProcess`` into 3 steps of the full-width VAE trainer with the
  kernel pair (8 launches of each per step), with each reader's
  batches/s, PostProcess ms per instance and s/step;
* ``evaluation``: the FID InceptionV3 and the CLIP extractor card vs CPU,
  then the evaluator CLI (``--device cuda``, a pytorch-fid-layout
  ``--inception_weights`` file) on 1,024 + 1,024 uint8 images of 256²:
  FID, sFID, IS, precision and recall, images/s, seconds by stage, peak
  memory, FID(ref, ref) < 1e-3; then ``--extractor clip``;
* ``sgm_stack``: the t23d EDM and the multi-view FM stacks of
  ``sgm_config.load_ldm_configs`` from parsed mappings: the CLIP-L text
  conditioner, the EDM loss and backward on DiT-L/2 at batch 4, 25 Euler
  CFG steps, the FM loss on DiT-I23D-L/2;
* ``profiling_trace``: ``utils.profiling.trace`` around 3 calls of the
  fused DiT-L/2 (kernel 3, 24 launches a call) in an ``annotate`` range;
* ``two_stage_demo``: the VAE and diffusion training entries for 2 steps
  each, then ``demo_two_stage`` at its defaults on their checkpoints
  (100 FM steps of DiT-B/2, 8 frames of 64², a 96³ mesh);
* ``gradio_i23d``: the image→3D demo's command-line fallback at its
  defaults (i23d DiT-L/2 in bf16, 75 FM steps, 12 frames of 128², a 128³
  grid; 32 launches of kernel 1 per image) over two 512² PNGs, then with
  ``--int8_dit``.  No kernel runs in ``evaluation``, ``sgm_stack`` and
  ``two_stage_demo`` (none does in JAX).

The serving calls after ``pipeline`` and ``serving_pipeline`` (i23d,
mv23d, ShapeNet, FFHQ, every int8 call and ``serving_mesh``) run ``SERVING_STEPS`` = 50
sampler steps where the release runs 250: the cut depth of those paths,
which keeps the whole run inside ``BUDGET_S``.  The DPM and PLMS calls
run their 25 steps, the sample CLI its preset's DDIM 250.

Before them it builds every CUDA kernel from ``ln3diff_tpu_torch/ops/csrc``
with nvcc and the native mesh and shard-reader code from
``ln3diff_tpu_torch/native`` with g++ and holds each kernel against its plain PyTorch version
(``kernel_check``, ``attention_check``, ``qkv_attention_check``,
``osg_backward_check``).  It also checks the mesh stage on an analytic
sphere (``mesh_check``), small text→3D, image→3D and multi-view→3D
models card against CPU (``small_reference``, ``small_reference_i23d``;
``small_reference_samplers``: DPM, PLMS and the int8 DiT;
``small_reference_unet``: the ShapeNet and FFHQ paths and the int8 U-Net;
``small_reference_fgbg``: a small fg/bg VAE) and a small training
step card against CPU (``small_train_reference``;
``small_ldm_train_reference``: a small DiT's step per objective;
``small_lsgm_train_reference``: a small LSGM joint step;
``small_adv_train_reference``: a small adversarial VAE step, kernels 1
and 2 on the card; ``small_eg3d_warmup_reference``: a small warm-up
step), and
profiles a
sampler step of each denoiser (``dit_profile``, ``i23d_dit_profile``,
``mv23d_dit_profile``).  It prints one JSON line per phase as the phase
finishes, then the ``{"kernels": [...]}`` line, the card's name and power
limit from nvidia-smi, and as its last line ``{"ok": true, "device":
{...}}``.  Any failed build, launch or check exits non-zero without the
last line, as does a machine without a CUDA device.  The run writes
nothing into the tree except the build directory
``ln3diff_tpu_torch/_build/``; the mesh files go to a temporary directory.

TF32: matmuls run in full f32 (PyTorch's default) and cuDNN's TF32 for f32
convolutions is switched off, so the f32 comparisons below hold the f32
arithmetic of both sides; the full-width path itself runs bf16.
"""

import copy
import dataclasses
import faulthandler
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

BUDGET_S = 900            # wall-clock budget of the whole run
# Sampler steps of every full-width serving call after the main path's
# two (``pipeline`` and ``serving_pipeline`` keep the release's DDIM 250):
# the i23d, mv23d, ShapeNet and FFHQ calls, all int8 calls and the
# sharded call of ``serving_mesh``.  A step is host-bound (35-100 ms on
# the card), and at 250 steps these calls took about 240 s, enough to
# push a run on a slower host over the budget.
SERVING_STEPS = 50
CUT = dict(sampler_steps=f'250 -> {SERVING_STEPS}')   # those phases' sizes
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 without tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores

# tolerances of the kernel against its plain version (elementwise
# |Δ| <= atol + rtol·|plain|).  f32 rows: only the order of the f32 MLP
# sums differs.  bf16 rows: both lerp in bf16 with the same rounding
# order; the margin covers the f32 sums and an occasional 1-ulp bf16 tie.
TOL = {'float32': (1e-4, 1e-4), 'bfloat16': (1e-2, 1e-2)}
# fused attention against its plain version: |Δ| <= atol + rtol·|plain|.
# f32: another summation order only.  bf16: both round p and o to bf16
# from f32 values summed in another order, so an element may land one
# bf16 ulp away (2^-7 relative) and a p one ulp away moves o by about
# 2^-8·p·|v|.
TOL_ATTN = {'float32': (2e-5, 2e-5), 'bfloat16': (4e-3, 1e-2)}
# kernel 4 against its plain version: kernel 3's tolerance.  The projection
# adds f32 sums of D products in another order (f32: a few ulps of q, k, v;
# bf16: now and then an element of q, k or v one bf16 ulp away, which moves
# o by about 2^-8·p·|v|); the attention is kernel 3's.
TOL_QKV = TOL_ATTN
# kernel 4's chain (x ← bf16(0.5·y + 0.5·x)) against the plain version's
# after 8 steps: |Δ| <= atol·max|plain| + rtol·|plain|.  Each step may put
# an element one bf16 ulp (2^-8 relative at most) away on either side, and
# the average carries half of each older difference on.
TOL_CHAIN = (1e-2, 2e-2)
# small-size pipeline, card vs CPU, both in f32: |Δ| <= TOL_PIPE·max(1,|ref|)
TOL_PIPE = 2e-3
# the small int8 model's latents, card vs CPU: |Δ| <= TOL_INT8·max(1,|ref|).
# The int8 products are exact int32 on both, but an activation within an f32
# ulp of a rounding midpoint quantizes one int8 step apart, and the ten CFG
# steps carry the flip on: on the CPU, 30 relative perturbations of 1e-7 of
# the start noise moved the latents by 1.4e-4 to 7.0e-3 of their scale.
TOL_INT8 = 2e-2
# the backward kernel against its plain version: |Δ| <= atol·max|plain| +
# rtol·|plain|.  Per-point f32 outputs: the f32 MLP sums run in another
# order.  bf16 row grads: w_k·round(g_f) rounds to bf16 on both sides and a
# g_f a few f32 ulps away may round to the neighbouring bf16 value, which
# moves the rounded product by up to two of its ulps (2^-6 relative).
# Weight grads: sums over all M points in another order.
TOL_BWD = {'point': (1e-5, 1e-4), 'grows_bf16': (1e-5, 2e-2),
           'weights': (1e-4, 1e-4)}
# small training step, card vs CPU, f32: the loss to TOL_TRAIN relative,
# each grad to TOL_TRAIN of its tensor's scale (with a floor of 1e-5 of
# the largest grad: grads that are zero in exact arithmetic hold rounding
# noise); after one AdamW step, weights whose grad is resolved to 1e-5 of
# scale plus 1e-2·lr, the rest (first-step Adam moves them by lr·sign of
# noise) within 2·lr
TOL_TRAIN = 1e-3
# the two routes of the full-width training step (bf16 compute): the
# first step's loss, kernel pair against plain PyTorch, relative
TOL_TRAIN_ROUTES = 1e-2
# the sharded serving call against the unsharded one on the same latents:
# at one rank each frame and σ chunk runs the unsharded path's own call,
# so the two are expected equal; |Δ| <= TOL_SERVING_MESH·max(1, |ref|)
TOL_SERVING_MESH = 1e-6
# dit_pipeline_apply at pp = 1 (4 microbatches) against the plain forward,
# f32 with TF32 off: the GEMMs of a microbatch sum in another order than
# the whole batch's; |Δ| <= TOL_PP1·max(1, |ref|)
TOL_PP1 = 1e-5
# the small LDM training step, card vs CPU, f32: the loss to TOL_LDM_TRAIN
# relative, each grad to TOL_LDM_TRAIN of its tensor's scale (floor 1e-5 of
# the largest grad), the AdamW step as TOL_TRAIN's
TOL_LDM_TRAIN = 2e-3
# the small LSGM joint step, card vs CPU, f32: the loss and each metric to
# TOL_LSGM_TRAIN relative, each grad to TOL_LSGM_TRAIN of its tensor's
# scale (floor 1e-5 of the largest grad), the AdamW step as TOL_TRAIN's
TOL_LSGM_TRAIN = 2e-3
# the small adversarial VAE step (kernels 1 and 2 on the card, the plain
# versions on the CPU), f32: the losses and the re-render to TOL_ADV_TRAIN
# relative, the VAE's and the discriminators' grads to TOL_ADV_TRAIN of
# scale (floor 1e-5 of the largest grad; R1 is a double backward through
# the discriminator), the AdamW steps as TOL_TRAIN's
TOL_ADV_TRAIN = 2e-3
# the small EG3D warm-up step, card vs CPU, f32: the loss and each term to
# TOL_EG3D_TRAIN relative, each grad to TOL_EG3D_TRAIN of its tensor's
# scale (floor 1e-5 of the largest grad), the AdamW step as TOL_TRAIN's
TOL_EG3D_TRAIN = 2e-3
# the full-width DiT-L/2's grads with remat 'dots' against no remat, bf16
# autocast: each to TOL_REMAT of its tensor's scale (floor 1e-5 of the
# largest grad); the recomputation runs the forward's kernels again, so
# only a kernel that sums in a data-dependent order can move a grad
TOL_REMAT = 1e-3
# the bf16 U-Net step in channels-last memory against its twin with NCHW
# convs, one call each on one input: |Δ| <= TOL_LAYOUT·max(1, |NCHW|).
# cuDNN may pick another algorithm per layout, which moves a bf16 sum by
# an ulp (2^-8 relative) here and there through 40-odd layers.
TOL_LAYOUT = 2e-2
# the evaluator's extractors card vs CPU, f32 with TF32 off: cuDNN's and
# the CPU's conv sums differ in order over the Inception's 94 convs
TOL_EVAL = 1e-3
# the serving path's mesh: σ > 10 inside, 192³ grid over ±0.45
MESH_GRID, MESH_AABB, MESH_THRESHOLD = 192, 0.45, 10.0

T0 = time.perf_counter()


class SmokeFailure(RuntimeError):
    pass


def emit(obj):
    print(json.dumps(obj), flush=True)


def elapsed():
    return time.perf_counter() - T0


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase_done(phase, t0, **fields):
    import torch
    torch.cuda.synchronize()
    emit({'phase': phase, 'seconds': round(time.perf_counter() - t0, 3),
          **fields})
    check(elapsed() < BUDGET_S,
          f'over the {BUDGET_S} s budget after phase {phase}')


def cuda_time_ms(fn, warmup=2, iters=10):
    """Median of ``iters`` CUDA-event timings after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def events_ms(fn, calls=50):
    """ms per call from CUDA events around ``calls`` back-to-back calls
    after two warm-up calls: the device's time per call wherever the
    host enqueues faster than the device runs."""
    import torch
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def device_ms(fn, calls=10, stages=None):
    """Device time per call of what ``fn`` launches, from torch.profiler
    (CUDA activity) over ``calls`` back-to-back calls after one warm-up
    call: the sum over every kernel and memset, or with ``stages``
    (``{key: part of a kernel's name}``) a dict of ms per stage.  None
    when the profiler shows no device time.  Unlike ``cuda_time_ms``, the
    wrapper's host time is not in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, by_stage = 0.0, {}
    for e in prof.key_averages():
        us = (getattr(e, 'self_device_time_total', None)
              or getattr(e, 'self_cuda_time_total', 0))
        if us <= 0:
            continue
        total += us / calls / 1e3
        for key, part in (stages or {}).items():
            if part in e.key:
                by_stage[key] = by_stage.get(key, 0.0) + us / calls / 1e3
    if stages is not None:
        return by_stage or None
    return total or None


def osg_inputs(M, rows_dtype, with_inbox, seed):
    """Kernel inputs at one call's shapes: rows (3, M, 128), tx/ty/live
    (3, M), inbox (M,), OSG weights with the EqualDense scaling folded."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    dev = 'cuda'
    rows = torch.randn((3, M, 128), generator=g, device=dev).to(rows_dtype)
    tx = torch.rand((3, M), generator=g, device=dev)
    ty = torch.rand((3, M), generator=g, device=dev)
    live = (torch.rand((3, M), generator=g, device=dev) > 0.05).float()
    inbox = None
    if with_inbox:
        inbox = (torch.rand((M,), generator=g, device=dev) > 0.2).float()
    w1 = torch.randn((32, 64), generator=g, device=dev) / 32**0.5
    b1 = torch.randn((64,), generator=g, device=dev) * 0.1
    w2 = torch.randn((64, 33), generator=g, device=dev) / 64**0.5
    b2 = torch.randn((33,), generator=g, device=dev) * 0.1
    return (rows, tx, ty, live, w1, b1, w2, b2), inbox


def osg_bound_ms(M, rows_itemsize, with_inbox):
    """Least time for one call: bytes (each input read once, each output
    written once) over HBM bandwidth vs the f32 MLP and lerp operations
    over the f32 rate; the larger of the two."""
    nbytes = (3 * M * 128 * rows_itemsize + 3 * 3 * M * 4
              + (4 * M if with_inbox else 0) + M * 33 * 4
              + 4 * (32 * 64 + 64 + 64 * 33 + 33))
    flops = M * (2 * 32 * 64 + 2 * 64 * 33 + 3 * 32 * 7 + 3 * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def kernel_check():
    """fused_osg against osg_pointwise_reference at the main path's
    shapes: a 192² × 64-sample render pass (with the bbox fold), the same
    with a ragged M, one σ-grid chunk of 2^18 points (no fold), f32 rows,
    and one training-step launch (M = 64·32², bf16, with the fold); each
    with the wrapper's host time per call (``host_us``); one frame of
    the FFHQ orbit's pass (128² rays × 48 samples over 256² planes, no
    fold) and one of the fg/bg orbit's fg pass (64² rays × 48 samples, no
    fold)."""
    import torch
    from ln3diff_tpu_torch.ops.fused_render import (osg_pointwise_fused,
                                                    osg_pointwise_reference)
    pass_M = 192 * 192 * 64
    cases = [('render_pass', pass_M, torch.bfloat16, True),
             ('render_pass_ragged', pass_M + 17, torch.bfloat16, True),
             ('sigma_chunk', 2**18, torch.bfloat16, False),
             ('render_pass_f32', 2**18 + 5, torch.float32, True),
             ('training_launch', 64 * 32 * 32, torch.bfloat16, True),
             ('ffhq_frame', 128 * 128 * 48, torch.bfloat16, False),
             ('fgbg_frame', 64 * 64 * 48, torch.bfloat16, False)]
    results = []
    for i, (name, M, dt, with_inbox) in enumerate(cases):
        args, inbox = osg_inputs(M, dt, with_inbox, seed=100 + i)
        rgb, sigma = osg_pointwise_fused(*args, inbox=inbox)
        torch.cuda.synchronize()
        rgb_ref, sigma_ref = osg_pointwise_reference(*args, inbox=inbox)
        atol, rtol = TOL[str(dt).split('.')[-1]]
        err_rgb = (rgb - rgb_ref).abs()
        err_sig = (sigma - sigma_ref).abs()
        ok = bool(torch.isfinite(rgb).all() and torch.isfinite(sigma).all()
                  and (err_rgb <= atol + rtol * rgb_ref.abs()).all()
                  and (err_sig <= atol + rtol * sigma_ref.abs()).all())
        ms = cuda_time_ms(lambda: osg_pointwise_fused(*args, inbox=inbox))
        dev_ms = device_ms(lambda: osg_pointwise_fused(*args, inbox=inbox))
        plain_ms = cuda_time_ms(
            lambda: osg_pointwise_reference(*args, inbox=inbox))
        bound, bound_by = osg_bound_ms(M, args[0].element_size(), with_inbox)
        res = dict(case=name, M=M, rows_dtype=str(dt), inbox=with_inbox,
                   max_abs_err_rgb=float(err_rgb.max()),
                   max_abs_err_sigma=float(err_sig.max()),
                   atol=atol, rtol=rtol, ok=ok, ms=ms, device_ms=dev_ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                   host_us=host_us(
                       lambda: osg_pointwise_fused(*args, inbox=inbox)))
        results.append(res)
        emit({'kernel_check': res})
        check(ok, f'fused_osg disagrees with its plain version on {name}')
        del args, inbox, rgb, sigma, rgb_ref, sigma_ref, err_rgb, err_sig
        torch.cuda.empty_cache()
    return results


def _small_card_vs_cpu(build, kw, inputs, fused, variant, shared=False,
                       tol_latents=TOL_PIPE, call_kw=None):
    """One small model from ``build`` (a ``build_*_pipeline``) on the CPU
    (seed 7) and on the card (a copy of the same weights), the same
    conditioning ``inputs`` and noise, f32: latents within ``tol_latents``
    of scale, planes and frames within ``TOL_PIPE``.  With ``shared`` the
    card's planes and frames are its decode and render of the CPU's
    latents (the toy model's latents reach a scale of several hundred,
    where the decoder turns their f32 differences into percent-level
    plane differences).  With ``fused`` the call also writes a mesh,
    whose OBJ must parse back, and the card run must launch kernel 3.
    ``call_kw``: the call's frames (default 2 frames of 32² rays); the
    noise has the shape of ``kw['sampler'].latent_shape``."""
    import torch
    from ln3diff_tpu_torch.ops.fused_attention import FusedAttention
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    cpu_pipe, cpu_enc, mods = build('cpu', seed=7, **kw)
    gpu_pipe, gpu_enc, _ = build(
        'cuda', modules={k: copy.deepcopy(m) for k, m in mods.items()}, **kw)
    noise = torch.randn((1,) + tuple(kw['sampler'].latent_shape),
                        generator=torch.Generator().manual_seed(3))
    call_kw = call_kw or dict(num_frames=2, render_resolution=32)
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, pipe, enc in (('cpu', cpu_pipe, cpu_enc),
                                ('cuda', gpu_pipe, gpu_enc)):
            FusedOSG.launches = FusedAttention.launches = 0
            cond, uncond = enc(inputs)
            mesh_kw = (dict(mesh_path=os.path.join(tmp, f'{name}.obj'),
                            mesh_grid=32) if fused else {})
            outs[name] = pipe(cond, uncond, x_init=noise, **call_kw,
                              **mesh_kw)
            if fused:
                nv, nf = obj_counts(mesh_kw['mesh_path'])
                check((nv, nf) == tuple(map(len, outs[name]['mesh'])),
                      f'{name}: the OBJ does not parse back')
    check(FusedOSG.launches > 0, 'the card run did not launch fused_osg')
    if fused:
        check(FusedAttention.launches > 0,
              'the card run did not launch fused_attention')
    r = dict(fused_osg_launches=FusedOSG.launches,
             fused_attention_launches=FusedAttention.launches)
    if shared:
        with torch.no_grad():
            planes = gpu_pipe.decode_fn(outs['cpu']['latents'].cuda())
            outs['cuda'] = dict(
                outs['cuda'], planes=planes,
                video=gpu_pipe.render_orbit(planes, **call_kw))
    for key in ('latents', 'planes', 'video'):
        ref = outs['cpu'][key]
        got = outs['cuda'][key].cpu()
        err = float((got - ref).abs().max())
        scale = max(1.0, float(ref.abs().max()))
        tol = (tol_latents if key == 'latents' else TOL_PIPE) * scale
        r[key] = dict(max_abs_err=err, tol=tol)
        check(bool(torch.isfinite(got).all()),
              f'{variant} {key}: non-finite on card')
        check(err <= tol,
              f'{variant} {key}: card vs CPU max|Δ| {err} > {tol}')
    if fused:
        r['triangles'] = dict(cpu=len(outs['cpu']['mesh'][1]),
                              cuda=len(outs['cuda']['mesh'][1]))
    return r


def _small_vae_kw():
    import torch
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    f32 = torch.float32
    return dict(
        vae_cfg=TriplaneVAEConfig(
            latent_size=8,
            dit2=DiT2Config(tokens_per_plane=16, hidden_size=64, depth=2,
                            num_heads=2, dtype=f32),
            conv_sr_ch=8, conv_sr_ch_mult=(1, 2), dtype=f32),
        render_opts=dataclasses.replace(
            RenderOptions(), depth_resolution=16,
            depth_resolution_importance=16, filter_out_of_bbox=True),
        render_resolution=32, render_dtype=None)


def small_reference():
    """A small model through the whole slice on the card and on the CPU,
    same weights and noise, f32 throughout: latents, planes and frames
    must agree (the CPU side runs the kernels' plain versions).  Twice:
    with the plain attention and no mesh, and as the serving call, with
    the fused-attention denoiser and a mesh_path."""
    import torch
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    from ln3diff_tpu_torch.models.dit import DiTConfig
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline

    res = {}
    for variant, fused in (('plain', False), ('fused_attention_mesh', True)):
        kw = dict(
            _small_vae_kw(),
            den_cfg=DiTConfig(input_size=8, hidden_size=64, depth=2,
                              num_heads=2, context_dim=64, exact_gelu=False,
                              fused_attention=fused, dtype=torch.float32),
            text_cfg=CLIPTextConfig(hidden_size=64, num_layers=2,
                                    num_heads=2, intermediate_size=128),
            sampler=SamplerSpec(kind='ddim', num_steps=10,
                                latent_shape=(8, 8, 12)))
        res[variant] = _small_card_vs_cpu(build_t23d_pipeline, kw,
                                          'a small wooden chair', fused,
                                          variant)
    return res


def small_reference_samplers():
    """``small_reference``'s model under the samplers and the int8 DiT of
    this slice: 10 DPM-Solver++(2M) steps over the unspaced schedule, 10
    PLMS steps over ``ddim10``, and DDIM 10 with ``quantized=True`` (the
    int8 GEMMs through ``torch._int_mm`` on the card and on the CPU).  The
    latents are held end to end (``TOL_PIPE``; ``TOL_INT8`` for int8), the
    planes and frames from one shared latent, the CPU's."""
    import torch
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    from ln3diff_tpu_torch.models.dit import DiTConfig
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline

    res = {}
    for variant, kind, quantized in (('dpm', 'dpm', False),
                                     ('plms', 'plms', False),
                                     ('int8', 'ddim', True)):
        kw = dict(
            _small_vae_kw(),
            den_cfg=DiTConfig(input_size=8, hidden_size=64, depth=2,
                              num_heads=2, context_dim=64, exact_gelu=False,
                              quantized=quantized, dtype=torch.float32),
            text_cfg=CLIPTextConfig(hidden_size=64, num_layers=2,
                                    num_heads=2, intermediate_size=128),
            sampler=SamplerSpec(kind=kind, num_steps=10,
                                latent_shape=(8, 8, 12)))
        res[variant] = _small_card_vs_cpu(
            build_t23d_pipeline, kw, 'a small wooden chair', False, variant,
            shared=True, tol_latents=TOL_INT8 if quantized else TOL_PIPE)
    return res


def small_reference_i23d():
    """``small_reference`` for the image→3D and multi-view→3D paths: a
    small DINOv2 tower with, for image→3D, a small CLIP vision tower and
    an ``'image-pixelart'`` DiT (two heads of 32; the self-attention runs
    over 48 latent and 5 DINO tokens), for multi-view→3D an
    ``'mv-pixelart'`` DiT (RMSNorm, the four views' 20 DINO tokens in the
    cross-attention), with the 10-step flow-matching ODE and CFG 4.0,
    card against CPU, plain and fused-attention with a mesh."""
    import torch
    from ln3diff_tpu_torch.conditioning.clip import CLIPVisionConfig
    from ln3diff_tpu_torch.models.dit import DiTConfig
    from ln3diff_tpu_torch.models.vit import vit_registry
    from ln3diff_tpu_torch.pipeline import (SamplerSpec, build_i23d_pipeline,
                                            build_mv23d_pipeline)

    f32 = torch.float32
    images = torch.rand((4, 28, 28, 3),
                        generator=torch.Generator().manual_seed(4)) * 2 - 1
    families = {
        'i23d': (build_i23d_pipeline, images[:1], dict(
            variant='image-pixelart', context_dim=64, pooled_vector_dim=64,
            dino_dim=64, t2i_final=True), dict(vision_cfg=CLIPVisionConfig(
                image_size=28, hidden_size=64, num_layers=2, num_heads=2,
                intermediate_size=128))),
        'mv23d': (build_mv23d_pipeline, images, dict(
            variant='mv-pixelart', context_dim=64), {})}
    res = {}
    for family, (build, inputs, den_kw, tower_kw) in families.items():
        for variant, fused in (('plain', False),
                               ('fused_attention_mesh', True)):
            kw = dict(
                _small_vae_kw(), **tower_kw,
                den_cfg=DiTConfig(input_size=8, hidden_size=64, depth=2,
                                  num_heads=2, exact_gelu=False,
                                  fused_attention=fused, dtype=f32,
                                  **den_kw),
                dino_cfg=vit_registry('dinov2-s/14', img_size=28,
                                      embed_dim=64, depth=2, num_heads=2,
                                      dtype=f32),
                sampler=SamplerSpec(kind='flow_matching', num_steps=10,
                                    cfg_scale=4.0, latent_shape=(8, 8, 12)))
            res[f'{family}_{variant}'] = _small_card_vs_cpu(build, kw, inputs, fused,
                                          f'{family} {variant}')
    return res


def small_reference_unet():
    """``small_reference`` for the ShapeNet and FFHQ paths: a small U-Net
    (roll-out, spatial transformer, mixing logit) under 4 DDIM steps of
    v-prediction, CFG 1.0 and 6.5, a small CLIP text tower with
    ``text_projection``, a small fusion-decoder VAE of each family (32
    plane channels, as kernel 1 takes them), 16² rays with 16+16 samples
    and the family's SR head: ``NearestConvSR`` over 2 frames, the
    full-width ``SuperresolutionHybrid8XDC`` (fixed widths, to 512²) over
    one.  Card against CPU, same weights and noise, f32.  ShapeNet's runs
    again with the int8 U-Net (``quantized=True``: ``Int8Conv`` and
    ``Int8Linear`` on ``torch._int_mm`` on both sides), its latents held
    within ``TOL_INT8`` and the planes and frames from the CPU's
    latents."""
    import torch
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    from ln3diff_tpu_torch.config import CAMERA_PRESETS, RENDER_PRESETS
    from ln3diff_tpu_torch.models.unet import UNetConfig
    from ln3diff_tpu_torch.models.vae_shapenet import (FFHQVAEConfig,
                                                       ShapeNetVAEConfig)
    from ln3diff_tpu_torch.models.vit import vit_registry
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_unet_pipeline
    from ln3diff_tpu_torch.render.camera import orbit_cameras

    f32 = torch.float32
    vae_kw = dict(encoder_vit=vit_registry('dinov2-s/14', img_size=28,
                                           embed_dim=64, depth=1,
                                           num_heads=2),
                  decoder_embed_dim=64, decoder_fusion_depth=2,
                  decoder_num_heads=2, channel_multiplier=1,
                  triplane_resolution=64, dtype=f32)
    families = {
        'shapenet': (ShapeNetVAEConfig(token_size=4, vae_p=2, **vae_kw),
                     'shapenet_tuneray_aug_resolution_64_64_nearestSR',
                     1.0, 2),
        'ffhq': (FFHQVAEConfig(token_size=8, **vae_kw), 'ffhq', 6.5, 1)}
    res = {}
    runs = [(family, False) for family in families] + [('shapenet', True)]
    for family, quantized in runs:
        vae_cfg, preset, cfg_scale, frames = families[family]
        kw = dict(
            den_cfg=UNetConfig(model_channels=32, num_res_blocks=1,
                               attention_resolutions=(2,),
                               channel_mult=(1, 2), num_heads=2,
                               context_dim=64, quantized=quantized,
                               dtype=f32),
            vae_cfg=vae_cfg,
            text_cfg=CLIPTextConfig(hidden_size=64, num_layers=2,
                                    num_heads=2, intermediate_size=128,
                                    with_projection=True),
            render_opts=dataclasses.replace(
                RENDER_PRESETS[preset], depth_resolution=16,
                depth_resolution_importance=16),
            render_resolution=16, render_dtype=None,
            sampler=SamplerSpec(kind='ddim', num_steps=4,
                                cfg_scale=cfg_scale,
                                triplane_scaling_divider=1.0,
                                latent_shape=(8, 8, 12)))
        cams = orbit_cameras(frames, **CAMERA_PRESETS[family])
        name = f'{family}_int8' if quantized else family
        res[name] = _small_card_vs_cpu(
            lambda *a, **k: build_unet_pipeline(family, *a, **k), kw,
            'a red sports car', False, name, shared=quantized,
            tol_latents=TOL_INT8 if quantized else TOL_PIPE,
            call_kw=dict(cameras=cams, render_resolution=16))
    return res


def small_reference_fgbg():
    """A small fg/bg VAE (``use_background``: 32 fg + 32 bg plane
    channels, as kernel 1 takes the fg half; the ``'stylegan'`` SR head ×2)
    on the CPU (seed 7) and on the card (a copy of the same weights), f32:
    the decode of one latent and a 2-frame orbit of 16² rays with the FFHQ
    render options (16+16 samples, 8 background samples), the fg pass
    through the fused route (kernel 1 on the card, its plain version on
    the CPU).  Planes and every render output within ``TOL_PIPE`` of
    scale; the card must launch kernel 1, the CPU must not."""
    import torch
    from ln3diff_tpu_torch.config import CAMERA_PRESETS, RENDER_PRESETS
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.render.camera import orbit_cameras
    f32 = torch.float32
    cfg = TriplaneVAEConfig(
        latent_size=8,
        dit2=DiT2Config(tokens_per_plane=16, hidden_size=64, depth=2,
                        num_heads=2, dtype=f32),
        conv_sr_ch=8, conv_sr_ch_mult=(1, 2), plane_channels=64,
        use_sr=True, sr_ratio=2, sr_module='stylegan', use_background=True,
        bg_depth_resolution=8, dtype=f32)
    cpu = TriplaneVAE(cfg)
    random_init_(cpu, torch.Generator().manual_seed(7))
    vaes = {'cpu': cpu.eval(), 'cuda': copy.deepcopy(cpu).cuda().eval()}
    latent = torch.randn((1, 8, 8, 12),
                         generator=torch.Generator().manual_seed(3))
    cams = torch.from_numpy(orbit_cameras(2, **CAMERA_PRESETS['ffhq']))
    opts = dataclasses.replace(RENDER_PRESETS['ffhq'], depth_resolution=16,
                               depth_resolution_importance=16)
    outs, launches = {}, {}
    for name, vae in vaes.items():
        dev = 'cpu' if name == 'cpu' else 'cuda'
        FusedOSG.launches = 0
        with torch.no_grad():
            planes = vae.decode_latent(latent.to(dev))
            outs[name] = dict(planes=planes, **vae.render(
                planes.expand(len(cams), -1, -1, -1, -1),
                cams.float().to(dev), opts, 16, use_fused_osg=True))
        launches[name] = FusedOSG.launches
    check(launches['cuda'] == 4 and launches['cpu'] == 0,
          f'kernel 1 launches {launches}, expected 4 on the card (2 '
          f'frames x coarse and fine) and none on the CPU')
    r = dict(fused_osg_launches=launches['cuda'])
    for key in ('planes', 'image_raw', 'image_sr', 'image_depth',
                'image_mask'):
        ref = outs['cpu'][key]
        got = outs['cuda'][key].cpu()
        err = float((got - ref).abs().max())
        tol = TOL_PIPE * max(1.0, float(ref.abs().max()))
        r[key] = dict(max_abs_err=err, tol=tol)
        check(bool(torch.isfinite(got).all()), f'fgbg {key}: non-finite')
        check(err <= tol, f'fgbg {key}: card vs CPU max|Δ| {err} > {tol}')
    return r


def attention_bound_ms(B, L, H, d, itemsize):
    """Least time for one call: 4·B·H·L²·d operations (q·kᵀ and p·v) over
    the rate of the operands' type (bf16 tensor cores, or f32 without
    them) against q, k, v read once and o written once over HBM
    bandwidth; the larger of the two."""
    flops = 4 * B * H * L * L * d
    rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = 4 * B * L * H * d * itemsize / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def host_us(fn, calls=20, repeats=5):
    """Median over ``repeats`` of the host time per call of ``calls``
    back-to-back calls (enqueue only: the card synchronises after the
    clock stops), in µs."""
    import torch
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def attention_check():
    """fused_attention against attention_reference on the card: the DiT's
    self-attention (q, k, v read in place from one (2, 768, 3·1024) qkv
    projection, bf16), the image→3D DiT's self-attention over its 768
    latent and 257 DINO tokens (L = 1025: the last query tile holds one
    row; q and k RMS-normalised into fresh tensors, v read in place), a
    ragged L, d = 32 (the small model's head), a long L = 2048 (the K/V
    ring streams far past shared memory) and f32 operands; each with the
    kernel's, the plain version's and
    scaled_dot_product_attention's times on the same inputs (CUDA events
    around one call, ``ms``, and the profiler's device time, ``device_ms``),
    and the host time per call of the kernel's wrapper and of the
    attention the DiT runs without the switch (``dot_product_attention``)."""
    import torch
    import torch.nn.functional as F
    from ln3diff_tpu_torch.models.layers import (RMSNorm,
                                                 dot_product_attention)
    from ln3diff_tpu_torch.ops.fused_attention import (attention_reference,
                                                       fused_attention)
    cases = [('dit_self_attention', 2, 768, 16, 64, torch.bfloat16),
             ('i23d_self_attention', 2, 1025, 16, 64, torch.bfloat16),
             ('ragged_L77', 2, 77, 16, 64, torch.bfloat16),
             ('head_dim_32', 2, 192, 2, 32, torch.bfloat16),
             ('long_L2048', 2, 2048, 16, 64, torch.bfloat16),
             ('dit_shape_f32', 2, 768, 16, 64, torch.float32)]
    results = []
    for i, (name, B, L, H, d, dt) in enumerate(cases):
        g = torch.Generator(device='cuda').manual_seed(200 + i)
        qkv = torch.randn((B, L, 3 * H * d), generator=g,
                          device='cuda').to(dt)
        q, k, v = (t.reshape(B, L, H, d) for t in qkv.chunk(3, dim=-1))
        if name.startswith('i23d'):
            # the DiT's qk_norm: q and k as fresh (B, L, H, d) tensors
            norm = RMSNorm(d).to('cuda', dt)
            with torch.no_grad():
                q, k = norm(q), norm(k)
        got = fused_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_reference(q, k, v)
        atol, rtol = TOL_ATTN[str(dt).split('.')[-1]]
        err = (got.float() - want.float()).abs()
        ok = bool(torch.isfinite(got).all()
                  and (err <= atol + rtol * want.float().abs()).all())
        ms = cuda_time_ms(lambda: fused_attention(q, k, v))
        plain_ms = cuda_time_ms(lambda: attention_reference(q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        dev_ms = device_ms(lambda: fused_attention(q, k, v))
        library_dev_ms = device_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound, bound_by = attention_bound_ms(B, L, H, d, q.element_size())
        res = dict(case=name, shape=[B, L, H, d], dtype=str(dt),
                   max_abs_err=float(err.max()), atol=atol, rtol=rtol,
                   ok=ok, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_device_ms=library_dev_ms,
                   bound_ms=bound, bound_by=bound_by,
                   host_us=host_us(lambda: fused_attention(q, k, v)),
                   dit_plain_host_us=host_us(
                       lambda: dot_product_attention(q, k, v)))
        results.append(res)
        emit({'attention_check': res})
        check(ok, f'fused_attention disagrees with its plain version on '
              f'{name}')
        del qkv, q, k, v, got, want, err
        torch.cuda.empty_cache()
    return results


def qkv_attention_bound_ms(B, L, D, H, itemsize):
    """Least time for one call of kernel 4: 2·B·L·D·3D (the qkv projection)
    + 4·B·H·L²·d (q·kᵀ and p·v) operations over the rate of the operands'
    type against x, the weights and the biases read once and the output
    written once over HBM bandwidth; the larger of the two."""
    d = D // H
    flops = 2 * B * L * D * 3 * D + 4 * B * H * L * L * d
    rate = BF16_FLOPS_PER_S if itemsize == 2 else F32_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    nbytes = (2 * B * L * D + 3 * D * D + 3 * D) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


def library_qkv_attention(x, w_t, b, num_heads):
    """The same function through library calls, for comparison only (the
    port never calls this): ``F.linear`` with the ``(3D, D)`` weight, the
    q | k | v split and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    B, L, D = x.shape
    qkv = F.linear(x, w_t, b).view(B, L, 3, num_heads, D // num_heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v)
    return o.transpose(1, 2).reshape(B, L, D)


def qkv_attention_check():
    """Kernel 4 (``fused_qkv_attention``) against its plain version on the
    card: the DiT-L/2 self-attention (2, 768, 1024, 16 heads) in bf16 with
    a nonzero bias, a ragged L = 77, d = 32 at (2, 96, 128, 4 heads), the
    DiT-L/2 shape in f32, and a port ``Attention(1024, 16)`` in f32 whose
    ``qkv`` weights go through ``split_qkv_weights``, held to
    ``attention_reference`` on that module's own q, k and v, and the DiT-L/2
    widths at L = 2048 in bf16.  Each with two launches compared bit for
    bit, the kernel's, the plain version's and the library calls'
    (``F.linear`` + SDPA) times on the same inputs (CUDA events, ``ms``;
    the profiler's device time, ``device_ms``), the wrapper's host time
    per call and the bound; for the first case also the device time of
    each of the kernel's two stages."""
    import torch
    from ln3diff_tpu_torch.models.dit import Attention
    from ln3diff_tpu_torch.ops.fused_attention import (
        FusedAttention, attention_reference, fused_qkv_attention,
        qkv_attention_reference, split_qkv_weights)
    cases = [('dit_l2_bf16', 2, 768, 1024, 16, torch.bfloat16),
             ('ragged_L77', 2, 77, 1024, 16, torch.bfloat16),
             ('head_dim_32', 2, 96, 128, 4, torch.bfloat16),
             ('dit_l2_f32', 2, 768, 1024, 16, torch.float32),
             ('dit_attention_module_f32', 2, 768, 1024, 16, torch.float32),
             ('dit_l2_L2048_bf16', 2, 2048, 1024, 16, torch.bfloat16)]
    results = []
    attn_before = FusedAttention.launches
    for i, (name, B, L, D, H, dt) in enumerate(cases):
        g = torch.Generator(device='cuda').manual_seed(500 + i)
        x = torch.randn((B, L, D), generator=g, device='cuda').to(dt)
        with torch.no_grad():
            if name.startswith('dit_attention_module'):
                torch.manual_seed(500 + i)
                module = Attention(D, H).to('cuda')
                w_t, b = module.qkv.weight, module.qkv.bias
                q, k, v = (t.reshape(B, L, H, D // H)
                           for t in module.qkv(x).chunk(3, dim=-1))
                want = attention_reference(q, k, v).reshape(B, L, D)
            else:
                w_t = (torch.randn((3 * D, D), generator=g, device='cuda')
                       / D**0.5).to(dt)
                b = (0.1 * torch.randn((3 * D,), generator=g,
                                       device='cuda')).to(dt)
            ws, bs = split_qkv_weights(w_t.T, b, H)
            args = (x, *ws, *bs)
            got = fused_qkv_attention(*args, num_heads=H)
            again = fused_qkv_attention(*args, num_heads=H)
            torch.cuda.synchronize()
            plain = qkv_attention_reference(*args, H)
            if not name.startswith('dit_attention_module'):
                want = plain
            atol, rtol = TOL_QKV[str(dt).split('.')[-1]]
            err = (got.float() - want.float()).abs()
            ok = bool(torch.isfinite(got).all()
                      and (err <= atol + rtol * want.float().abs()).all())
            ms = cuda_time_ms(lambda: fused_qkv_attention(*args, num_heads=H))
            plain_ms = cuda_time_ms(lambda: qkv_attention_reference(*args,
                                                                    H))
            library_ms = cuda_time_ms(
                lambda: library_qkv_attention(x, w_t, b, H))
            dev_ms = device_ms(lambda: fused_qkv_attention(*args,
                                                           num_heads=H))
            library_dev_ms = device_ms(
                lambda: library_qkv_attention(x, w_t, b, H))
            wrapper_us = host_us(lambda: fused_qkv_attention(*args,
                                                             num_heads=H))
            stage_ms = (device_ms(
                lambda: fused_qkv_attention(*args, num_heads=H),
                stages=dict(projection='projection_kernel',
                            attention='attention_kernel'))
                if i == 0 else None)
        bound, bound_by = qkv_attention_bound_ms(B, L, D, H, x.element_size())
        res = dict(case=name, shape=[B, L, D, H], dtype=str(dt),
                   max_abs_err=float(err.max()),
                   out_abs_max=float(want.float().abs().max()),
                   atol=atol, rtol=rtol, ok=ok,
                   deterministic=bool(torch.equal(got, again)), ms=ms,
                   device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_device_ms=library_dev_ms,
                   host_us=wrapper_us, bound_ms=bound, bound_by=bound_by,
                   stage_ms=stage_ms)
        results.append(res)
        emit({'qkv_attention_check': res})
        check(ok, f'fused_qkv_attention disagrees with its plain version on '
              f'{name}')
        check(res['deterministic'], f'fused_qkv_attention is not '
              f'repeatable on {name}')
        del x, args, got, again, plain, want, err
        torch.cuda.empty_cache()
    check(FusedAttention.launches == attn_before,
          'fused_qkv_attention moved FusedAttention.launches')
    return results


def qkv_attention_chain(steps=1000, check_steps=8):
    """Kernel 4's path, the port's counterpart of ``.bench_megakernel.py``
    at its shapes: B=2, L=768, D=1024, H=16, bf16, wqkv = 0.02·N(0, 1),
    bqkv = 0, x₀ = 0.1·N(0, 1) from a ``torch.Generator`` seed, and
    x ← bf16(0.5·y + 0.5·x) for ``steps`` steps with y from
    ``fused_qkv_attention`` (the mega chain), from ``F.linear`` + split +
    SDPA (the library chain, for comparison only) and, for
    ``check_steps`` steps, from the plain version.  The mega chain must
    agree with the plain chain after ``check_steps`` steps and stay finite
    to the end.  Launch counts are reset to 0 just before the mega chain
    and read just after; µs per step from CUDA events around each
    chain."""
    import torch
    from ln3diff_tpu_torch.ops.fused_attention import (
        FusedAttention, FusedQKVAttention, fused_qkv_attention,
        qkv_attention_reference, split_qkv_weights)
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    B, L, D, H = 2, 768, 1024, 16
    dt = torch.bfloat16
    g = torch.Generator(device='cuda').manual_seed(0)
    x0 = (0.1 * torch.randn((B, L, D), generator=g, device='cuda')).to(dt)
    wqkv = (0.02 * torch.randn((D, 3 * D), generator=g,
                               device='cuda')).to(dt)
    bqkv = torch.zeros((3 * D,), dtype=dt, device='cuda')
    ws, bs = split_qkv_weights(wqkv, bqkv, H)
    w_t = wqkv.T.contiguous()
    chains = {
        'mega': lambda x: fused_qkv_attention(x, *ws, *bs, num_heads=H),
        'library': lambda x: library_qkv_attention(x, w_t, bqkv, H),
        'plain': lambda x: qkv_attention_reference(x, *ws, *bs, H)}

    def run(name, n, keep=None):
        """n steps from x₀; (µs per step, last x, x after ``keep`` steps)."""
        fn = chains[name]
        x, kept = x0, None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(n):
            x = (0.5 * fn(x) + 0.5 * x).to(dt)
            if i + 1 == keep:
                kept = x.clone()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n * 1e3, x, kept

    res = {}
    with torch.no_grad():
        for name in chains:          # one warm-up step each
            run(name, 1)
        plain_us, plain_x, _ = run('plain', check_steps)
        FusedOSG.launches = FusedAttention.launches = 0
        FusedQKVAttention.launches = 0
        mega_us, mega_x, mega_kept = run('mega', steps, keep=check_steps)
        torch.cuda.synchronize()
        launches = (FusedQKVAttention.launches, FusedAttention.launches,
                    FusedOSG.launches)
        library_us, library_x, library_kept = run('library', steps,
                                                  keep=check_steps)
    check(launches == (steps, 0, 0), f'the mega chain launched kernels 4, '
          f'3 and 1 {launches} times, expected ({steps}, 0, 0)')
    atol, rtol = TOL_CHAIN
    ref = plain_x.float()
    scale = float(ref.abs().max())
    err = (mega_kept.float() - ref).abs()
    ok = bool((err <= atol * scale + rtol * ref.abs()).all())
    res.update(
        shape=[B, L, D, H], dtype=str(dt), steps=steps,
        fused_qkv_attention_launches=launches[0],
        us_per_step=dict(mega=mega_us, library=library_us, plain=plain_us),
        check_steps=check_steps,
        mega_vs_plain=dict(max_abs_err=float(err.max()), scale=scale,
                           atol=atol, rtol=rtol, ok=ok),
        library_vs_plain_max_abs_err=float(
            (library_kept.float() - ref).abs().max()),
        final_abs_max=dict(mega=float(mega_x.float().abs().max()),
                           library=float(library_x.float().abs().max())))
    check(ok, f'mega chain vs plain chain after {check_steps} steps: '
          f'max|Δ| {float(err.max())} at scale {scale}')
    check(bool(torch.isfinite(mega_x).all()),
          f'the {steps}-step mega chain is not finite')
    return res


def osg_bwd_bound_ms(M, rows_itemsize, with_inbox):
    """Least time for one backward call: bytes (the forward's inputs, the
    cotangents g_rgb and g_σ read once; the row, tx/ty/live and inbox
    grads written once; the weights and their grads) over HBM bandwidth
    vs the f32 operations (the forward recomputed, the two transposed
    products, the weight-grad sums and the corner sums) over the f32
    rate; the larger of the two."""
    per_point_in = (3 * 128 * rows_itemsize + 3 * 3 * 4
                    + (4 if with_inbox else 0) + 32 * 4 + 4)
    per_point_out = (3 * 128 * rows_itemsize + 3 * 3 * 4
                     + (4 if with_inbox else 0))
    weights = 4 * (32 * 64 + 64 + 64 * 33 + 33)
    nbytes = M * (per_point_in + per_point_out) + 2 * weights
    forward = 2 * 32 * 64 + 2 * 64 * 33 + 3 * 32 * 7 + 3 * 8
    backward = (2 * 33 * 64 * 2 + 2 * 32 * 64 * 2 + 3 * 128
                + 3 * 4 * 32 * 2 + 3 * 20)
    flops = M * (forward + backward)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops
                                 else 'operations')


# kernel 2's two launches, by a part of their names
BWD_STAGES = {'main': 'osg_backward_kernel', 'reduce': 'reduce_partials'}
BWD_NAMES = ('grows', 'gtx', 'gty', 'glive', 'ginbox', 'gw1', 'gb1', 'gw2',
             'gb2')


def _bwd_errors(got, want, rows_dtype):
    """max |Δ| per output and whether each is within TOL_BWD."""
    errs, ok = {}, True
    for name, a, b in zip(BWD_NAMES, got, want):
        if b is None:
            ok &= a is None
            continue
        if name.startswith(('gw', 'gb')):
            atol, rtol = TOL_BWD['weights']
        elif name == 'grows' and rows_dtype == 'bfloat16':
            atol, rtol = TOL_BWD['grows_bf16']
        else:
            atol, rtol = TOL_BWD['point']
        a, b = a.float(), b.float()
        err = (a - b).abs()
        scale = float(b.abs().max())
        ok &= bool(a.shape == b.shape and a.isfinite().all()
                   and (err <= atol * scale + rtol * b.abs()).all())
        errs[name] = float(err.max())
    return errs, ok


def osg_backward_check():
    """Kernel 2 (``osg_pointwise_backward``) against its plain version on
    all nine outputs: one training-step launch (M = 64·32² points of a
    patch-32 render, bf16 rows, bbox fold), f32 rows, lrelu without the
    fold and a ragged M, each with its device time split between the
    main kernel and the reduce of the weight-grad partials and the
    wrapper's host time; then autograd through the kernel pair against
    autograd of the plain forward, in f32."""
    import torch
    from ln3diff_tpu_torch.ops.fused_render import (
        osg_pointwise_backward, osg_pointwise_backward_reference,
        osg_pointwise_fused, osg_pointwise_reference)
    train_M = 64 * 32 * 32
    cases = [('training_launch', train_M, torch.bfloat16, True, 'sigmoid'),
             ('f32_rows', train_M, torch.float32, True, 'sigmoid'),
             ('lrelu_no_inbox', train_M, torch.bfloat16, False, 'lrelu'),
             ('ragged_1001', 1001, torch.bfloat16, True, 'sigmoid')]
    results = []
    for i, (name, M, dt, with_inbox, act) in enumerate(cases):
        args, inbox = osg_inputs(M, dt, with_inbox, seed=300 + i)
        g = torch.Generator(device='cuda').manual_seed(400 + i)
        g_rgb = torch.randn((M, 32), generator=g, device='cuda')
        g_sig = torch.randn((M, 1), generator=g, device='cuda')

        def kernel():
            return osg_pointwise_backward(*args, g_rgb, g_sig,
                                          activation=act, inbox=inbox)

        def plain():
            return osg_pointwise_backward_reference(
                *args, g_rgb, g_sig, activation=act, inbox=inbox)

        got = kernel()
        torch.cuda.synchronize()
        errs, ok = _bwd_errors(got, plain(), str(dt).split('.')[-1])
        again = kernel()
        deterministic = all(
            (a is None and b is None) or bool(torch.equal(a, b))
            for a, b in zip(got, again))
        bound, bound_by = osg_bwd_bound_ms(M, args[0].element_size(),
                                           with_inbox)
        res = dict(case=name, M=M, rows_dtype=str(dt), inbox=with_inbox,
                   activation=act, max_abs_err=errs, ok=ok,
                   deterministic=deterministic,
                   ms=cuda_time_ms(kernel), device_ms=device_ms(kernel),
                   device_ms_by_stage=device_ms(kernel, stages=BWD_STAGES),
                   host_us=host_us(kernel), plain_ms=cuda_time_ms(plain),
                   bound_ms=bound, bound_by=bound_by)
        results.append(res)
        emit({'osg_backward_check': res})
        check(ok, f'fused_osg backward disagrees with its plain version '
              f'on {name}')
        check(deterministic, f'fused_osg backward is not repeatable on '
              f'{name}')
        del args, inbox, g_rgb, g_sig, got, again
        torch.cuda.empty_cache()

    # autograd through the kernel pair, f32
    M = train_M
    args, inbox = osg_inputs(M, torch.float32, True, seed=310)
    g = torch.Generator(device='cuda').manual_seed(410)
    g_rgb = torch.randn((M, 32), generator=g, device='cuda')
    g_sig = torch.randn((M, 1), generator=g, device='cuda')
    grads = {}
    for route, fn in (('kernel', osg_pointwise_fused),
                      ('plain', osg_pointwise_reference)):
        leaves = [a.clone().requires_grad_() for a in args]
        box = inbox.clone().requires_grad_()
        rgb, sigma = fn(*leaves, inbox=box)
        ((rgb * g_rgb).sum() + (sigma * g_sig).sum()).backward()
        grads[route] = [t.grad for t in leaves] + [box.grad]
    torch.cuda.synchronize()
    names = ['rows', 'tx', 'ty', 'live', 'w1', 'b1', 'w2', 'b2', 'inbox']
    auto = {}
    for name, a, b in zip(names, grads['kernel'], grads['plain']):
        atol, rtol = TOL_BWD['weights' if name[0] in 'wb'
                             and name != 'inbox' else 'point']
        err = (a - b).abs()
        ok = bool(torch.isfinite(a).all() and (
            err <= atol * float(b.abs().max()) + rtol * b.abs()).all())
        auto[name] = float(err.max())
        check(ok, f'autograd through the kernels: grad of {name} differs')
    emit({'osg_backward_autograd': dict(M=M, max_abs_err=auto)})
    return results, auto


def _train_cfgs(small):
    """(model config, train config, loss config, render options) of the
    small card-vs-CPU step or of the full-width step."""
    import torch
    from ln3diff_tpu_torch.config import RENDER_PRESETS, vae_preset
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    from ln3diff_tpu_torch.training.losses import LossConfig
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainConfig
    if small:
        # the kernels' widths (32 plane channels, 32 colour channels), the
        # rest tiny; f32
        model = TriplaneVAEConfig(
            encoder_ch=8, encoder_ch_mult=(1, 2), img_resolution=32,
            num_views=2, latent_size=16,
            dit2=DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                            num_heads=2, dtype=torch.float32),
            conv_sr_ch=8, conv_sr_ch_mult=(1, 2), dtype=torch.float32)
        train = VAETrainConfig(lr=2e-3, patch_resolution=16,
                               render_resolution=32, ema_rate=0.5,
                               use_fused_osg=True)
        opts = RenderOptions(depth_resolution=16,
                             depth_resolution_importance=16,
                             filter_out_of_bbox=True)
        loss = LossConfig(lpips_lambda=0.0, ssim_lambda=0.2, l1_lambda=0.3)
        return model, train, loss, opts
    return (vae_preset('objaverse'),
            VAETrainConfig(lr=1e-4, grad_clip=0.5, ema_rate=0.9999,
                           patch_resolution=32, render_resolution=128),
            LossConfig(depth_lambda=0.5, lpips_lambda=0.0),
            RENDER_PRESETS['objverse_tuneray_aug_resolution_64_64_auto'])


def small_train_reference():
    """One training step of a small VAE on the card (``use_fused_osg=True``:
    kernels 1 and 2) and on the CPU (plain versions), f32, from the same
    weights, batch and draws: the loss, every grad and the parameters
    after the AdamW step must agree; the OSG decoder's weights must get
    non-zero grads on the card."""
    import torch
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.render.renderer import draw_uniforms
    from ln3diff_tpu_torch.training.vae_trainer import TrainDraws, VAETrainer

    model_cfg, train_cfg, loss_cfg, opts = _train_cfgs(small=True)
    raw = make_multiview_batch(2, 32, 32, seed=5)
    cpu = VAETrainer(model_cfg, train_cfg, loss_cfg, render_opts=opts,
                     seed=3, device='cpu')
    card = VAETrainer(model_cfg, train_cfg, loss_cfg, render_opts=opts,
                      seed=3, device='cuda')
    card.model.load_state_dict(cpu.model.state_dict())
    g = torch.Generator().manual_seed(4)
    R = train_cfg.patch_resolution**2
    draws = TrainDraws(torch.randn((1, 16, 16, 4, 3), generator=g),
                       draw_uniforms(2, R, opts, g, 'cpu'))
    out = {}
    for name, tr in (('cpu', cpu), ('cuda', card)):
        dev = tr.device
        d = TrainDraws(draws.eps.to(dev),
                       type(draws.render)(*(t.to(dev)
                                            for t in draws.render)))
        batch = tr.prepare_batch(raw)
        FusedOSG.launches = FusedOSG.backward_launches = 0
        loss, _ = tr.loss_fn(batch, draws=d)
        loss.backward()
        grads = {k: p.grad.detach().cpu()
                 for k, p in tr.model.named_parameters()}
        tr.model.zero_grad(set_to_none=True)
        tr.train_step(batch, draws=d)
        out[name] = dict(
            loss=loss.item(), grads=grads,
            params={k: p.detach().cpu() for k, p in tr.state.params.items()},
            launches=(FusedOSG.launches, FusedOSG.backward_launches))
    check(out['cpu']['launches'] == (0, 0), 'the CPU run launched kernels')
    fwd, bwd = out['cuda']['launches']
    check(fwd > 0 and bwd > 0, 'the card step did not launch both kernels')
    lc, lg = out['cpu']['loss'], out['cuda']['loss']
    check(abs(lg - lc) <= TOL_TRAIN * abs(lc), f'loss {lg} vs CPU {lc}')
    gmax = max(float(v.abs().max()) for v in out['cpu']['grads'].values())
    worst_grad, worst_param, n_resolved = 0.0, 0.0, 0
    lr = train_cfg.lr
    for k, want in out['cpu']['grads'].items():
        got = out['cuda']['grads'][k]
        tol = max(TOL_TRAIN * float(want.abs().max()), 1e-5 * gmax)
        err = float((got - want).abs().max())
        worst_grad = max(worst_grad, err / max(tol, 1e-30) * TOL_TRAIN)
        check(err <= tol, f'grad of {k}: card vs CPU max|Δ| {err} > {tol}')
        if k.startswith('osg_decoder.'):
            check(float(got.abs().max()) > 0, f'{k}: zero grad on the card')
        p_cpu, p_card = out['cpu']['params'][k], out['cuda']['params'][k]
        perr = (p_card - p_cpu).abs()
        resolved = want.abs() >= 10 * tol
        n_resolved += int(resolved.sum())
        check(float(perr.max()) <= 2 * lr + 1e-6, f'{k}: step off by more '
              f'than 2·lr')
        ptol = 1e-5 * float(p_cpu.abs().max()) + 1e-2 * lr
        check(bool((perr[resolved] <= ptol).all()),
              f'{k}: the AdamW step differs where the grad is resolved')
        worst_param = max(worst_param, float(perr[resolved].max())
                          if resolved.any() else 0.0)
    return dict(loss_cpu=lc, loss_cuda=lg,
                loss_rel_err=abs(lg - lc) / abs(lc),
                grad_err_in_units_of_tol=worst_grad / TOL_TRAIN,
                resolved_weights=n_resolved,
                max_step_err_resolved=worst_param,
                fused_osg_launches=fwd, fused_osg_backward_launches=bwd,
                tensors=len(out['cpu']['grads']))


def _step_profile(trainer, raw, gen, top=6):
    """One training step under torch.profiler (CUDA activity): device
    kernel time, the time of the fused point kernels, the largest
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = trainer.prepare_batch(raw)
    batch['step'] = 0.0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch, generator=gen)
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, 'self_device_time_total', None) \
            or getattr(e, 'self_cuda_time_total', 0)
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    if not events:
        return dict(device_ms=None)
    osg = {}
    for e in events:
        for kind in ('osg_forward_kernel', 'osg_backward_kernel',
                     'reduce_partials_kernel'):
            if kind in e.key:
                osg[kind] = osg.get(kind, 0.0) + dev_us(e) / 1e3
    return dict(
        device_ms=sum(dev_us(e) for e in events) / 1e3,
        kernel_launches=sum(e.count for e in events),
        fused_osg_kernels_ms=osg,
        top_kernels=[dict(name=e.key[:80], ms=dev_us(e) / 1e3,
                          calls=e.count)
                     for e in sorted(events, key=dev_us, reverse=True)[:top]])


def vae_train(steps=5, warmup=2):
    """The training step at the released width (``vae_preset('objaverse')``,
    bf16 compute over f32 parameters, patch 32 of a 128² render, 64+64
    samples, AdamW lr 1e-4, clip 0.5, EMA 0.9999, one synthetic instance of
    4 views at 256²), with the kernel pair (``use_fused_osg=True``) and with
    plain PyTorch, from the same random weights (seed 0) and the same
    draws.  Each route is built and warmed up (``warmup`` steps; its peak
    memory above what was resident before it); both stay resident and the
    ``steps`` timed steps of each run in turns (fused, plain, plain, fused,
    ...; host clock, synchronised per step), with the launch counts of
    kernels 1 and 2 reset to 0 just before and read just after.  Also: the
    first step's loss of both routes, which parameter tensors that step
    moved and how often the two routes moved a weight the same way, and
    one profiled step per route."""
    import torch
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainer

    model_cfg, base_cfg, loss_cfg, opts = _train_cfgs(small=False)
    raw = make_multiview_batch(4, 256, 128, seed=0)
    routes = {'fused': True, 'plain': False}
    trainers, gens, res, first = {}, {}, {}, {}
    init = None
    for route, fused in routes.items():
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = VAETrainer(model_cfg, dataclasses.replace(
            base_cfg, use_fused_osg=fused), loss_cfg, render_opts=opts,
            seed=0, device='cuda')
        gen = torch.Generator(device='cuda').manual_seed(1)
        if init is None:
            init = {k: p.detach().clone()
                    for k, p in tr.model.named_parameters()}
        losses, norms = [], []
        for i in range(warmup):
            batch = tr.prepare_batch(raw)
            batch['step'] = float(i)
            m = tr.train_step(batch, generator=gen)
            losses.append(float(m['loss']))
            norms.append(float(m['grad_norm']))
            if i == 0:
                first[route] = {k: p.detach() - init[k]
                                for k, p in tr.model.named_parameters()}
        torch.cuda.synchronize()
        res[route] = dict(
            peak_mem_gib=round((torch.cuda.max_memory_allocated()
                                - resident) / 2**30, 3),
            losses=losses, grad_norms=norms, secs=[], launches=[0, 0],
            params=sum(p.numel() for p in tr.model.parameters()),
            tensors=len(list(tr.model.parameters())),
            not_moved=[k for k, d in first[route].items()
                       if not bool(d.any())])
        trainers[route], gens[route] = tr, gen
    del init
    same = moved = 0
    for k, d in first['fused'].items():
        e = first['plain'][k]
        both = (d != 0) & (e != 0)
        moved += int(both.sum())
        same += int((both & ((d > 0) == (e > 0))).sum())
    del first

    order = (['fused', 'plain', 'plain', 'fused'] * steps)[:2 * steps]
    FusedOSG.launches = FusedOSG.backward_launches = 0
    for i, route in enumerate(order):
        tr = trainers[route]
        batch = tr.prepare_batch(raw)
        batch['step'] = float(warmup + len(res[route]['secs']))
        n0 = (FusedOSG.launches, FusedOSG.backward_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch, generator=gens[route])
        torch.cuda.synchronize()
        r = res[route]
        r['secs'].append(time.perf_counter() - t0)
        r['losses'].append(float(m['loss']))
        r['grad_norms'].append(float(m['grad_norm']))
        r['launches'][0] += FusedOSG.launches - n0[0]
        r['launches'][1] += FusedOSG.backward_launches - n0[1]
    total = (FusedOSG.launches, FusedOSG.backward_launches)

    for route, r in res.items():
        r['profile'] = _step_profile(trainers[route], raw, gens[route])
        check(all(math.isfinite(x) for x in r['losses']),
              f'{route}: non-finite loss {r["losses"]}')
        not_moved = r.pop('not_moved')
        check(not [k for k in not_moved if k.startswith('osg_decoder.')],
              f'{route}: the first step did not move the OSG decoder')
        # zero-initialised biases whose grad is zero at the first step
        # (adaLN-zero blocks start as the identity) stay where they are
        r['tensors_not_moved_by_step_1'] = len(not_moved)
        r['not_moved_examples'] = not_moved[:4]
        r.update(s_per_step=sum(r['secs']) / len(r['secs']),
                 s_per_step_runs=r.pop('secs'),
                 fused_osg_launches=r['launches'][0],
                 fused_osg_backward_launches=r['launches'][1],
                 fused_osg_launches_per_step=r['launches'][0] / steps,
                 fused_osg_backward_launches_per_step=(r['launches'][1]
                                                       / steps))
        del r['launches']
    del trainers
    f, p = res['fused'], res['plain']
    check(total == (f['fused_osg_launches'], f['fused_osg_backward_launches']),
          'fused_osg launched outside the fused route\'s steps')
    check(f['fused_osg_launches_per_step'] == 8
          and f['fused_osg_backward_launches_per_step'] == 8,
          f'fused route: {f["fused_osg_launches_per_step"]} forward and '
          f'{f["fused_osg_backward_launches_per_step"]} backward launches '
          f'per step, expected 8 and 8')
    check(p['fused_osg_launches'] == 0
          and p['fused_osg_backward_launches'] == 0,
          'plain route launched the fused kernels')
    rel = abs(f['losses'][0] - p['losses'][0]) / abs(p['losses'][0])
    check(rel <= TOL_TRAIN_ROUTES, f'first-step loss: fused '
          f'{f["losses"][0]} vs plain {p["losses"][0]}')
    res['first_loss_rel_diff'] = rel
    res['first_step_same_direction_share'] = same / max(moved, 1)
    res['timed_order'] = order
    return res


def obj_counts(path):
    """(vertex lines, face lines) of an OBJ file, read in 64 MiB blocks;
    the first vertex line must parse to 6 floats and the first face line
    to 3 indices."""
    nv = nf = 0
    prev = b'\n'
    with open(path, 'rb') as f:
        head = f.read(1 << 16)
        f.seek(0)
        while True:
            block = f.read(1 << 26)
            if not block:
                break
            buf = prev + block
            nv += buf.count(b'\nv ')
            nf += buf.count(b'\nf ')
            prev = buf[-2:]
    lines = head.split(b'\n')
    vl = next((ln for ln in lines if ln.startswith(b'v ')), None)
    fl = next((ln for ln in lines if ln.startswith(b'f ')), None)
    if vl is not None:
        check(len([float(x) for x in vl.split()[1:]]) == 6,
              f'bad vertex line {vl!r}')
    if fl is not None:
        check(len([int(x) for x in fl.split()[1:]]) == 3,
              f'bad face line {fl!r}')
    return nv, nf


def mesh_check(point_decoder):
    """The host mesh stage on an analytic field and the colour query on the
    card: a sphere of radius 0.3 (σ = 10 + 200·(0.3 − r), f16 like the
    grid query) on the serving grid goes through the device census and
    march_grid, every vertex within one voxel of the sphere; the vertex
    colours come from ``point_decoder`` (real decoder planes) through the
    fused point kernel; the OBJ parses back to the same mesh."""
    import numpy as np
    import torch
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.render import mesh
    g, aabb, radius = MESH_GRID, MESH_AABB, 0.3
    pts = mesh.grid_points(g, aabb, device='cuda')
    sigma = (MESH_THRESHOLD + (radius - pts.norm(dim=-1)) * 200.0).half()
    n_cross = int(mesh.count_crossing_cells(sigma, g, MESH_THRESHOLD))
    t0 = time.perf_counter()
    sigma_np = sigma.cpu().numpy().reshape(g, g, g)
    verts, faces = mesh.march_grid(sigma_np, g, aabb, MESH_THRESHOLD)
    march_s = time.perf_counter() - t0
    voxel = 2 * aabb / (g - 1)
    dev = float(np.abs(np.linalg.norm(verts, axis=-1) - radius).max())
    check(len(faces) > 0, 'sphere: no triangles')
    check(n_cross == mesh._crossing_cells(
        sigma_np.astype(np.float32), MESH_THRESHOLD).size,
        'device crossing census disagrees with the host scan')
    check(dev < voxel, f'sphere: a vertex {dev} from the surface, voxel '
          f'{voxel}')
    before = FusedOSG.launches
    rgb = mesh.dispatch_vertex_colors(point_decoder, verts, device='cuda')
    rgb8 = mesh.dispatch_vertex_colors(point_decoder, verts, as_uint8=True,
                                       device='cuda')
    torch.cuda.synchronize()
    launches = FusedOSG.launches - before
    check(launches > 0, 'vertex colours did not launch fused_osg')
    check(bool(torch.isfinite(rgb).all()), 'vertex colours not finite')
    # the sigmoid head's range is [-0.001, 1.001]; exported colours clip
    rmin, rmax = float(rgb.min()), float(rgb.max())
    check(-0.001 - 1e-6 <= rmin and rmax <= 1.001 + 1e-6,
          f'vertex colours out of range [{rmin}, {rmax}]')
    colors = np.clip(rgb.cpu().numpy(), 0.0, 1.0)
    check(bool(torch.equal(rgb8.cpu(), torch.from_numpy(
        (colors * 255.0).astype(np.uint8)))), 'uint8 colours disagree')
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'sphere.obj')
        mesh.export_obj(path, mesh.rotate_x(verts), colors, faces)
        nv, nf = obj_counts(path)
        data = np.loadtxt(path, comments='f', usecols=(1, 2, 3, 4, 5, 6))
    check((nv, nf) == (len(verts), len(faces)),
          f'OBJ parses to {nv} vertices / {nf} faces, wrote '
          f'{len(verts)} / {len(faces)}')
    check(np.abs(data[:, :3] - mesh.rotate_x(verts)).max() <= 1e-6
          and np.abs(data[:, 3:] - colors).max() <= 1e-4,
          'OBJ coordinates or colours do not read back')
    return dict(grid=g, crossing_cells=n_cross, triangles=len(faces),
                max_vertex_offset=dev, voxel=voxel,
                march_seconds=round(march_s, 3),
                color_launches=launches, colors_range=[rmin, rmax])


def fused_denoiser(denoiser):
    """The DiT-L/2 serving denoiser with ``fused_attention=True``, holding
    the weights of ``denoiser`` (the first path's)."""
    import torch
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent
    cfg = dataclasses.replace(denoiser.cfg, fused_attention=True)
    with torch.device('cuda'):
        fused = DiT_TriLatent(cfg)
    fused.load_state_dict(denoiser.state_dict())
    return fused.to(cfg.dtype).eval()


def serving_pipeline(modules, prompt):
    """The text→3D serving call at full width (``_serving_call``) with the
    fused-attention DiT-L/2 in ``modules['denoiser']``."""
    from ln3diff_tpu_torch.pipeline import build_t23d_pipeline
    den_cfg = modules['denoiser'].cfg
    check(den_cfg.fused_attention, 'the serving denoiser is not fused')
    pipe, encode, _ = build_t23d_pipeline('cuda', den_cfg=den_cfg,
                                          modules=modules)
    return _serving_call(pipe, encode, prompt, 'text_encode')


def image_pipeline(build, modules, inputs, repeat=True):
    """The image→3D or multi-view→3D call at full width
    (``_serving_call``) with ``SERVING_STEPS`` Euler steps of the
    flow-matching ODE at CFG 4.0: ``build`` is ``build_i23d_pipeline`` or
    ``build_mv23d_pipeline``, the denoiser in ``modules`` has plain or
    fused attention, ``inputs`` are the image or the views."""
    from ln3diff_tpu_torch.pipeline import SamplerSpec
    pipe, encode, _ = build('cuda', den_cfg=modules['denoiser'].cfg,
                            modules=modules,
                            sampler=SamplerSpec(cfg_scale=4.0,
                                                num_steps=SERVING_STEPS))
    return _serving_call(pipe, encode, inputs, 'image_encode',
                         repeat=repeat)[0]


def t23d_samplers(modules, prompt):
    """The text→3D serving call at full width (``_serving_call``, the
    DiT-L/2 of ``modules``) with ``kind='dpm'``, 25 DPM-Solver++(2M) steps
    over the unspaced 1000-step schedule (``bench.py``'s ``dpm25``), and
    with ``kind='plms'``, 25 PLMS steps over ``ddim25``: 26 denoiser
    calls each."""
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline
    res = {}
    for kind in ('dpm', 'plms'):
        pipe, encode, _ = build_t23d_pipeline(
            'cuda', den_cfg=modules['denoiser'].cfg, modules=modules,
            sampler=SamplerSpec(kind=kind, num_steps=25))
        check(pipe.diffusion.num_timesteps == (1000 if kind == 'dpm'
                                               else 25),
              f'{kind}: schedule of {pipe.diffusion.num_timesteps} steps')
        res[f'{kind}25'] = r = _serving_call(pipe, encode, prompt,
                                             'text_encode')[0]
        check(r['denoiser_calls'] == 26, f'{kind}25 called the denoiser '
              f'{r["denoiser_calls"]} times')
    return res


def int8_gemm_ms(M=1536, K=1024, N=3072):
    """The DiT-L/2 qkv projection's GEMM at a CFG step's shape (B·L rows
    of the doubled batch), ms per call from CUDA events around 50
    back-to-back calls: ``torch._int_mm`` with the weight operand
    column-major (``Int8Linear``'s stored layout) and row-major, against
    the bf16 ``F.linear`` of the same shape, and the int8 path's whole
    ``int8_dense`` (row quantization, GEMM, rescale)."""
    import torch
    import torch.nn.functional as F
    from ln3diff_tpu_torch.ops.int8 import int8_dense, quantize_weight
    g = torch.Generator(device='cuda').manual_seed(11)
    x = torch.randn((M, K), generator=g, device='cuda').to(torch.bfloat16)
    w = torch.randn((N, K), generator=g, device='cuda') / K**0.5
    wq, scale = quantize_weight(w.t())
    kq = wq.t().contiguous()                       # (N, K): kq.t() col-major
    xq = torch.randint(-127, 128, (M, K), generator=g, device='cuda',
                       dtype=torch.int8)
    kq_rows = kq.t().contiguous()                  # (K, N) row-major
    wb = w.to(torch.bfloat16)
    return dict(
        shape=[M, K, N],
        int_mm_col_major_ms=events_ms(lambda: torch._int_mm(xq, kq.t())),
        int_mm_row_major_ms=events_ms(lambda: torch._int_mm(xq, kq_rows)),
        int8_dense_ms=events_ms(lambda: int8_dense(x, kq, scale)),
        bf16_linear_ms=events_ms(lambda: F.linear(x, wb)),
        gemm_ops=2 * M * K * N)


def t23d_int8(modules, fused_modules, cond, uncond, prompt):
    """The text→3D serving call at full width with the W8A8 int8 DiT-L/2:
    ``quantize_dit`` of the plain and of the fused-attention denoiser
    (``bench.py``'s ``LN3DIFF_BENCH_INT8``), DDIM ``SERVING_STEPS``;
    kernel 3 runs on the int8 qkv projection of the fused one.  Then a
    DDIM step of the four denoisers (bf16 and int8, plain and fused) under
    the profiler, and the qkv GEMM alone.  ``latents_rel_to_bf16``: the
    int8 call's latents against the bf16 denoiser's, sampled with the
    same DDIM steps from the same noise.  Each call runs once, timed by
    phase (``repeat=False``)."""
    import torch
    from ln3diff_tpu_torch.ops.int8 import Int8Linear, quantize_dit
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline
    sampler = SamplerSpec(kind='ddim', num_steps=SERVING_STEPS)
    res, dens = {}, {}
    for attn, mods in (('plain_attention', modules),
                       ('fused_attention', fused_modules)):
        bf16_pipe, _, _ = build_t23d_pipeline(
            'cuda', den_cfg=mods['denoiser'].cfg, modules=mods,
            sampler=sampler)
        with torch.no_grad():
            ref = bf16_pipe.sample_latents(
                1, cond, uncond,
                generator=torch.Generator(device='cuda').manual_seed(1))
        t0 = time.perf_counter()
        q = quantize_dit(mods['denoiser'])
        quant_s = time.perf_counter() - t0
        n_int8 = sum(isinstance(m, Int8Linear) for m in q.modules())
        check(q.cfg.quantized and n_int8 == 24 * 8,
              f'quantize_dit gave {n_int8} int8 layers')
        pipe, encode, _ = build_t23d_pipeline(
            'cuda', den_cfg=q.cfg, modules=dict(mods, denoiser=q),
            sampler=sampler)
        r, lat = _serving_call(pipe, encode, prompt, 'text_encode',
                               repeat=False)
        r['latents_rel_to_bf16'] = float((lat - ref).norm() / ref.norm())
        r['quantize_seconds'] = round(quant_s, 3)
        r['int8_layers'] = n_int8
        res[attn] = r
        dens[f'bf16_{attn}'] = mods['denoiser']
        dens[f'int8_{attn}'] = q
    res['step_profile'] = dit_profile(dens, cond, uncond)
    res['qkv_gemm'] = int8_gemm_ms()
    return res


def orbit_options(modules, cond, uncond):
    """The serving call's orbit options at full width on a DPM-25 call:
    ``__call__(cameras=...)`` with the 24-view orbit at pitch 13.73°,
    radius 1.772 (the release asset's first rows) written with
    ``torch.save`` and read back by ``load_pose_asset``, its frames held to
    the analytic ring of the same poses; then the same call with
    ``render_rays_fn`` (``TriplaneVAE.render_rays_flat``, frames folded
    into the ray axis), its frames held to the per-frame orbit within
    ``TOL_PIPE`` and kernel 1's launches counted."""
    import numpy as np
    import torch
    from ln3diff_tpu_torch.config import RENDER_PRESETS
    from ln3diff_tpu_torch.ops.fused_attention import FusedAttention
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline
    from ln3diff_tpu_torch.render.camera import (load_pose_asset,
                                                 orbit_cameras)
    pipe, _, _ = build_t23d_pipeline(
        'cuda', den_cfg=modules['denoiser'].cfg, modules=modules,
        sampler=SamplerSpec(kind='dpm', num_steps=25))
    cams = orbit_cameras(24, 1.772, 30.0, 13.73)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'objv_eval_pose.pt')
        torch.save(torch.from_numpy(cams), path)
        loaded = load_pose_asset(path)
    check(loaded.shape == (24, 25) and np.array_equal(loaded, cams),
          'load_pose_asset did not read the poses back')
    res = {}

    def call(key):
        FusedOSG.launches = FusedAttention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(cond, uncond, cameras=loaded, render_resolution=192,
                   generator=torch.Generator(device='cuda').manual_seed(1))
        torch.cuda.synchronize()
        video = out['video']
        check(tuple(video.shape) == (1, 24, 192, 192, 3),
              f'{key}: video shape {tuple(video.shape)}')
        check(bool(torch.isfinite(video).all()), f'{key}: frames not finite')
        vmin, vmax = float(video.min()), float(video.max())
        check(-1.01 <= vmin and vmax <= 1.01,
              f'{key}: frames out of range [{vmin}, {vmax}]')
        res[key] = dict(call_seconds=round(time.perf_counter() - t0, 3),
                        fused_osg_launches=FusedOSG.launches,
                        fused_attention_launches=FusedAttention.launches,
                        frames_range=[vmin, vmax])
        check(FusedOSG.launches > 0, f'{key}: fused_osg not launched')
        return out

    out = call('cameras')
    planes = out['planes'].to(pipe.render_dtype)
    with torch.no_grad():
        ring = pipe.render_orbit(planes, 24, radius=1.772, pitch_deg=13.73,
                                 render_resolution=192)
    err = float((ring - out['video']).abs().max())
    res['cameras']['max_abs_err_vs_ring'] = err
    check(err <= TOL_PIPE, f'cameras: frames {err} from the analytic ring')
    vae = modules['vae']
    opts = RENDER_PRESETS['objverse_tuneray_aug_resolution_64_64_auto']
    pipe.render_rays_fn = lambda planes, o, d: vae.render_rays_flat(
        planes, o, d, opts, use_fused_osg=True)
    flat = call('flat_rays')
    check(bool(torch.equal(flat['latents'], out['latents'])),
          'flat_rays: the call sampled other latents')
    err = float((flat['video'] - out['video']).abs().max())
    res['flat_rays']['max_abs_err_vs_per_frame'] = err
    res['flat_rays']['tol'] = TOL_PIPE
    check(err <= TOL_PIPE, f'flat rays: frames {err} from the per-frame '
          f'orbit')
    return res


def _serving_call(pipe, encode, inputs, encode_key, sample_key='dit_sample',
                  call_kw=None, shapes=None, mesh=True, sr_head=None,
                  repeat=True):
    """A serving call at full width: ``__call__`` (with a ``mesh_path``
    unless ``mesh`` is False) on the conditioning ``encode(inputs)``.  The
    call runs twice from the same noise: once as a user runs it (its wall
    time, ``call_seconds``; skipped with ``repeat=False``, which keeps
    every check of the second run), then with every stage under a
    synchronising timer, so the seconds by phase (``encode_key`` for the conditioning,
    ``sample_key`` for the denoiser) add up without the overlap of march
    and orbit; launches are counted per phase in the second run, kernel 3
    once per block and denoiser call with fused attention and never
    without, and the denoiser calls: one per step, plus one for
    DPM-Solver's last x0 and PLMS's warm-up.  ``call_kw``: the call's
    orbit (default 24 frames of 192² rays); ``shapes``: the expected
    latents, planes and video shapes.  With ``sr_head`` (a render-space SR
    module) the render's time is split into ``render_rays`` (rays and
    kernel 1) and ``sr_head``; the first call returns uint8 frames
    (``video_uint8``), which must be within one level of the second
    call's float frames converted (the SR frames are unbounded, so no
    range check).  Returns
    the phase's fields and the sampled latents."""
    import numpy as np
    import torch
    from ln3diff_tpu_torch.ops.fused_attention import (FusedAttention,
                                                       FusedQKVAttention)
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.pipeline import frames_to_uint8
    from ln3diff_tpu_torch.render import mesh as mesh_mod

    den_cfg = pipe.denoiser_fn.cfg
    fused_attention = getattr(den_cfg, 'fused_attention', False)
    call_kw = call_kw or dict(num_frames=24, render_resolution=192)
    shapes = shapes or dict(latents=(1, 32, 32, 12),
                            planes=(1, 3, 128, 128, 32),
                            video=(1, 24, 192, 192, 3))

    def call(path, **kw):
        mesh_kw = dict(mesh_path=path, mesh_grid=MESH_GRID,
                       mesh_smooth=True) if mesh else {}
        return pipe(cond, uncond, batch=1, **call_kw, **mesh_kw,
                    generator=torch.Generator(device='cuda').manual_seed(1),
                    **kw)

    check(repeat or sr_head is None, 'the SR frames are checked against '
          'the first run')
    untimed, call_s = None, None
    if repeat:
        cond, uncond = encode(inputs)
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            untimed = call(os.path.join(tmp, 'untimed.obj'),
                           video_uint8=sr_head is not None)
            torch.cuda.synchronize()
            call_s = round(time.perf_counter() - t0, 3)

    secs, osg, last, calls = {}, {}, {}, {}

    def timed(key, fn):
        secs[key] = 0.0

        def run(*a, **k):
            torch.cuda.synchronize()
            n0, t0 = FusedOSG.launches, time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[key] += time.perf_counter() - t0
            osg[key] = osg.get(key, 0) + FusedOSG.launches - n0
            calls[key] = calls.get(key, 0) + 1
            last[key] = out
            return out
        return run

    encode = timed(encode_key, encode)
    pipe.denoiser_fn = timed(sample_key, pipe.denoiser_fn)
    pipe.decode_fn = timed('vae_decode', pipe.decode_fn)
    pipe.render_fn = timed('render', pipe.render_fn)
    if sr_head is not None:
        sr_head.forward = timed('sr_head', sr_head.forward)
    pipe.dispatch_mesh_sigma = timed('sigma_query', pipe.dispatch_mesh_sigma)
    stages = dict(count_crossing_cells='crossing_count', march_grid='march',
                  dispatch_vertex_colors='vertex_colors',
                  export_obj='export')
    originals = {n: getattr(mesh_mod, n) for n in stages}
    for n, key in stages.items():
        setattr(mesh_mod, n, timed(key, originals[n]))
    try:
        cond, uncond = encode(inputs)
        FusedOSG.launches = FusedAttention.launches = 0
        FusedQKVAttention.launches = 0
        calls.clear()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, 'out.obj')
            t0 = time.perf_counter()
            out = call(path)
            torch.cuda.synchronize()
            timed_s = time.perf_counter() - t0
            attn_launches = FusedAttention.launches
            osg_launches = FusedOSG.launches
            qkv_launches = FusedQKVAttention.launches
            nv, nf = obj_counts(path) if mesh else (0, 0)
            obj_bytes = os.path.getsize(path) if mesh else 0
    finally:
        for n, fn in originals.items():
            setattr(mesh_mod, n, fn)
        if sr_head is not None:
            del sr_head.forward

    video, latents, planes = out['video'], out['latents'], out['planes']
    verts, faces = out['mesh'] if mesh else ((), ())
    check(untimed is None or bool(torch.equal(untimed['latents'], latents)),
          'the timed and the untimed call sample different latents')
    for key, t in (('latents', latents), ('planes', planes),
                   ('video', video)):
        check(tuple(t.shape) == shapes[key],
              f'{key} shape {tuple(t.shape)}, expected {shapes[key]}')
        check(bool(torch.isfinite(t).all()), f'{key} not finite')
    vmin, vmax = float(video.min()), float(video.max())
    if sr_head is None:
        check(-1.01 <= vmin and vmax <= 1.01,
              f'frames out of range [{vmin}, {vmax}]')
    else:
        # cuDNN's conv sums may run in another order in the other call,
        # which moves a frame value across a uint8 level now and then
        got_u8 = untimed['video']
        check(isinstance(got_u8, np.ndarray) and got_u8.dtype == np.uint8
              and got_u8.shape == shapes['video'],
              'video_uint8 did not return uint8 frames of the video shape')
        off = np.abs(got_u8.astype(np.int16)
                     - frames_to_uint8(video).cpu().numpy())
        check(int(off.max()) <= 1, f'the video_uint8 frames are up to '
              f'{int(off.max())} levels from the float frames converted')
        uint8_off = dict(max_levels=int(off.max()),
                         share_off=float((off > 0).mean()))
    check(qkv_launches == 0, 'the serving call launched kernel 4')
    den_calls = calls[sample_key]
    want_calls = pipe.spec.num_steps + (pipe.spec.kind in ('dpm', 'plms'))
    check(den_calls == want_calls, f'{den_calls} denoiser calls, expected '
          f'{want_calls} for {pipe.spec.num_steps} {pipe.spec.kind} steps')
    want_attn = den_cfg.depth * den_calls if fused_attention else 0
    check(attn_launches == want_attn, f'fused_attention launched '
          f'{attn_launches} times, expected {want_attn}')
    check(osg['render'] > 0, 'render did not launch fused_osg')
    launches = dict(render=osg['render'])
    res = {} if sr_head is None else dict(video_uint8_vs_float=uint8_off)
    if mesh:
        check(bool(torch.isfinite(last['sigma_query']).all()),
              'sigma grid not finite')
        check(tuple(last['sigma_query'].shape) == (MESH_GRID**3,),
              'sigma grid shape')
        check((nv, nf) == (len(verts), len(faces)),
              f'OBJ parses to {nv} vertices / {nf} faces, the call '
              f'returned {len(verts)} / {len(faces)}')
        check(osg['sigma_query'] > 0, 'sigma query did not launch fused_osg')
        check(len(verts) == 0 or osg['vertex_colors'] > 0,
              'vertex colours did not launch fused_osg')
        launches.update(sigma_query=osg['sigma_query'],
                        vertex_colors=osg['vertex_colors'])
        n_cross = int(last['crossing_count'])
        cells = (MESH_GRID - 1)**3
        res.update(
            crossing_cells=n_cross,
            sigma_field=('empty' if n_cross == 0 else 'noise-like'
                         if n_cross > 0.05 * cells else 'surface'),
            triangles=len(faces), vertices=len(verts),
            max_tris_cap_hit=len(faces) >= 20_000_000, obj_bytes=obj_bytes,
            sigma_range=[float(last['sigma_query'].min()),
                         float(last['sigma_query'].max())])
    check(osg_launches == sum(launches.values()),
          'fused_osg launched outside the phases')
    by_phase = {k: round(v, 3) for k, v in secs.items()
                if k in calls or k == encode_key}
    if sr_head is not None:
        by_phase['render_rays'] = round(secs['render'] - secs['sr_head'], 3)
    return dict(
        seconds_by_phase=by_phase,
        call_seconds=call_s, timed_call_seconds=round(timed_s, 3),
        sampler=f'{pipe.spec.kind}{pipe.spec.num_steps}',
        denoiser_calls=den_calls,
        quantized=getattr(den_cfg, 'quantized', False),
        fused_attention_launches=attn_launches,
        fused_osg_launches=launches, frames_range=[vmin, vmax],
        frames_dtype=str(video.dtype),
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3),
        **res), latents


def dit_profile(denoisers, cond, uncond, steps=5, t_value=500,
                latent_shape=(32, 32, 12), doubled=True):
    """Where a sampler step's time goes, for each denoiser (at time
    ``t_value``: a DDIM step index, or a flow-matching time in [0, 1)):
    the host wall time of one CFG call (batch 2 over [cond; uncond], or
    with ``doubled=False`` batch 1 over cond, as CFG 1.0 runs; no
    profiler, synchronised at the end of ``steps`` calls, the denoisers
    timed in turns and each one's two runs averaged), the device time of
    its kernels under torch.profiler (CUDA activity only), their ratio
    (the device's busy share of the step) and the kernels that take the
    most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device='cuda').manual_seed(5)
    B = 2 if doubled else 1
    x = torch.randn((B,) + tuple(latent_shape), generator=g, device='cuda')
    t = torch.full((B,), t_value, device='cuda')
    ctx = ({k: torch.cat([cond[k], uncond[k]]) for k in cond} if doubled
           else cond)
    names = list(denoisers)
    walls = {name: [] for name in names}
    with torch.no_grad():
        for name in names:
            denoisers[name](x, t, ctx)
        # in turns, A B B A, so that a drift of the host's speed falls on
        # both alike
        for name in names + names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                denoisers[name](x, t, ctx)
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) / steps * 1e3)
    res = {}
    for name, den in denoisers.items():
        wall_ms = sum(walls[name]) / len(walls[name])
        with torch.no_grad():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    den(x, t, ctx)
                torch.cuda.synchronize()

        def dev_us(e):
            return getattr(e, 'self_device_time_total', None) \
                or getattr(e, 'self_cuda_time_total', 0)
        events = [e for e in prof.key_averages() if dev_us(e) > 0]
        step_ms = sum(dev_us(e) for e in events) / steps / 1e3
        top = sorted(events, key=dev_us, reverse=True)[:6]
        res[name] = dict(
            wall_ms_per_step=wall_ms, wall_ms_runs=walls[name],
            device_ms_per_step=step_ms if events else None,
            device_busy_share=step_ms / wall_ms if events else None,
            top_kernels=[dict(name=e.key[:80],
                              ms_per_step=dev_us(e) / steps / 1e3,
                              calls_per_step=e.count / steps)
                         for e in top])
    return res


def i23d_int8(build, modules, inputs, cond, uncond):
    """The image→3D serving call at full width (``SERVING_STEPS`` FM
    steps) with ``quantize_dit`` of the plain-attention DiT-I23D-L/2
    (``bench.py``'s ``LN3DIFF_BENCH_INT8`` for i23d), run once, timed by
    phase, and an FM step of it and of the bf16 denoiser under the
    profiler."""
    from ln3diff_tpu_torch.ops.int8 import quantize_dit
    q = quantize_dit(modules['denoiser'])
    res = image_pipeline(build, dict(modules, denoiser=q), inputs,
                         repeat=False)
    res['step_profile'] = dit_profile(
        {'bf16_plain_attention': modules['denoiser'],
         'int8_plain_attention': q}, cond, uncond, t_value=0.5)
    del q
    return res


def image_families():
    """The image→3D and multi-view→3D serving calls at full width, each
    family's models built once (random weights, seed 0) and freed before
    the next family's: the call with plain attention (as ``bench.py``
    runs it, twice) and with ``fused_attention=True`` (once, timed by
    phase), then one flow-matching
    step of both denoisers under the profiler.  The inputs are drawn in
    [-1, 1] from a seeded ``torch.Generator``: one 224² image for i23d,
    four 224² views for mv23d."""
    import torch
    from ln3diff_tpu_torch.pipeline import (build_i23d_pipeline,
                                            build_mv23d_pipeline)
    results = {}
    for family, build, n_images in (('i23d', build_i23d_pipeline, 1),
                                    ('mv23d', build_mv23d_pipeline, 4)):
        t0 = time.perf_counter()
        _, encode, modules = build('cuda', seed=0)
        g = torch.Generator(device='cuda').manual_seed(6)
        inputs = torch.rand((n_images, 224, 224, 3), generator=g,
                            device='cuda') * 2 - 1
        cond, uncond = encode(inputs)
        phase_done(f'{family}_pipeline_build', t0, weights=(
            'random (torch.Generator seed 0); ' + (
                'CLIP ViT-L/14 vision f32, DINOv2-B/14 bf16, DiT-I23D-L/2'
                if family == 'i23d' else 'DINOv2-B/14 bf16 over 4 views, '
                'DiT-PixArt-MV-L/2') + ' bf16 tanh-GELU, DiT2-L/2 VAE '
            f'decoder bf16; flow-matching Euler {SERVING_STEPS} steps '
            '(250 in the release), cfg 4.0, '
            '24 x 192^2 orbit, 64+64 samples, bf16 planes, 192^3 sigma '
            'grid, mesh'),
            context={k: list(v.shape) for k, v in cond.items()})
        res = {}
        t0 = time.perf_counter()
        res['plain_attention'] = image_pipeline(build, modules, inputs)
        plain_denoiser = modules['denoiser']
        fused_modules = dict(modules,
                             denoiser=fused_denoiser(plain_denoiser))
        # the timed run only: the plain call above repeats as a user runs
        # it
        res['fused_attention'] = image_pipeline(build, fused_modules, inputs,
                                                repeat=False)
        phase_done(f'{family}_pipeline', t0, sizes=CUT, **res)
        t0 = time.perf_counter()
        profile = dit_profile({'plain_attention': plain_denoiser,
                               'fused_attention': fused_modules['denoiser']},
                              cond, uncond, t_value=0.5)
        phase_done(f'{family}_dit_profile', t0, **profile)
        if family == 'i23d':
            t0 = time.perf_counter()
            res['int8'] = i23d_int8(build, modules, inputs, cond, uncond)
            phase_done('i23d_int8', t0, sizes=CUT, **res['int8'])
        results[family] = res
        del modules, fused_modules, plain_denoiser, encode, cond, uncond
        torch.cuda.empty_cache()
    return results


def unet_families():
    """The ShapeNet and FFHQ text→3D calls at full width
    (``build_unet_pipeline``, random weights from seed 0, each family's
    models freed before the next's): the call as the bench configures it,
    at DDIM ``SERVING_STEPS``
    (``_serving_call`` on the family's 24-frame orbit from
    ``CAMERA_PRESETS``, ShapeNet with a mesh), ShapeNet's mesh stage on an
    analytic sphere with the colours from its planes (``mesh_check``: the
    random σ field is empty), then one DDIM step of the U-Net under the
    profiler: batch 1 over the conditional half (ShapeNet, CFG 1.0),
    batch 2 CFG-doubled (FFHQ, CFG 6.5), each beside a twin with the
    same weights whose convs are in NCHW memory (the layout cuDNN's sm90
    convs transpose on every call).  Each family's call runs again with
    ``quantize_unet`` of its U-Net (``{family}_int8``), and
    ``unet_int8_profile`` holds a DDIM step of the int8 U-Net beside the
    bf16 one."""
    import copy
    import torch
    from ln3diff_tpu_torch.config import CAMERA_PRESETS
    from ln3diff_tpu_torch.ops.int8 import Int8Conv, Int8Linear, quantize_unet
    from ln3diff_tpu_torch.pipeline import UNET_FAMILIES, build_unet_pipeline
    from ln3diff_tpu_torch.render.camera import orbit_cameras
    results, steps, int8 = {}, {}, {}
    prompt = 'a red sports car'
    for family, spec in UNET_FAMILIES.items():
        mesh = family == 'shapenet'
        t0 = time.perf_counter()
        pipe, encode, modules = build_unet_pipeline(family, 'cuda', seed=0)
        sampler = dataclasses.replace(pipe.spec, num_steps=SERVING_STEPS)
        pipe, encode, _ = build_unet_pipeline(family, 'cuda',
                                              modules=modules,
                                              sampler=sampler)
        rays = spec['ray_res']
        side = rays * modules['vae'].cfg.sr_ratio
        phase_done(f'{family}_pipeline_build', t0, weights=(
            'random (torch.Generator seed 0); U-Net-320 LSGM bf16 (v-pred, '
            'mixing logit), CLIP-L text f32 with text_projection, pooled x'
            f'{spec["clip_scale"]}, {type(modules["vae"]).__name__} '
            f'decoder bf16; ddim{SERVING_STEPS} (250 in the release), '
            f'cfg {pipe.spec.cfg_scale}, 24 x '
            f'{rays}^2-ray orbit + '
            f'{type(modules["vae"].superresolution).__name__} to '
            f'{side}^2, bf16 planes' + (', 192^3 sigma grid, mesh'
                                        if mesh else '')),
            parameters=sum(p.numel() for m in modules.values()
                           for p in m.parameters()))
        t0 = time.perf_counter()
        cams = orbit_cameras(24, **CAMERA_PRESETS[family])
        call_args = dict(
            sample_key='unet_sample',
            call_kw=dict(cameras=cams, render_resolution=rays),
            shapes=dict(latents=(1, *pipe.spec.latent_shape),
                        planes=(1, 3, 256, 256, 32),
                        video=(1, 24, side, side, 3)),
            mesh=mesh, sr_head=modules['vae'].superresolution)
        res, latents = _serving_call(pipe, encode, prompt, 'text_encode',
                                     **call_args)
        if mesh:
            with torch.no_grad():
                planes = pipe.decode_fn(latents)
            res['mesh_on_sphere'] = mesh_check(pipe._mesh_decoder(
                planes.to(torch.bfloat16)))
        phase_done(f'{family}_pipeline', t0, sizes=CUT, **res)
        results[family] = res
        # the same call with the W8A8 int8 U-Net
        t0 = time.perf_counter()
        q = quantize_unet(modules['denoiser'])
        quant_s = time.perf_counter() - t0
        n_conv = sum(isinstance(m, Int8Conv) for m in q.modules())
        n_lin = sum(isinstance(m, Int8Linear) for m in q.modules())
        check(q.cfg.quantized and n_conv > 0 and n_lin > 0,
              f'quantize_unet gave {n_conv} int8 convs, {n_lin} linears')
        qpipe, qencode, _ = build_unet_pipeline(
            family, 'cuda', den_cfg=q.cfg, modules=dict(modules, denoiser=q),
            sampler=sampler)
        qres, qlat = _serving_call(qpipe, qencode, prompt, 'text_encode',
                                   **call_args)
        qres.update(latents_rel_to_bf16=float((qlat - latents).norm()
                                              / latents.norm()),
                    quantize_seconds=round(quant_s, 3),
                    int8_convs=n_conv, int8_linears=n_lin)
        phase_done(f'{family}_int8', t0, sizes=CUT, **qres)
        results[f'{family}_int8'] = qres
        # CFG 1.0 runs the conditional half only: batch 1
        steps[family] = (modules['denoiser'], *encode(prompt),
                         pipe.spec.latent_shape, pipe.spec.cfg_scale != 1.0)
        int8[family] = q
        del pipe, encode, modules, qpipe, qencode
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    profiles = {}
    for family, (den, cond, uncond, shape, doubled) in steps.items():
        nchw = copy.deepcopy(den)
        for mod in nchw.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.to(memory_format=torch.contiguous_format)
        B = 2 if doubled else 1
        g = torch.Generator(device='cuda').manual_seed(6)
        x = torch.randn((B, *shape), generator=g, device='cuda')
        t = torch.full((B,), 500, device='cuda')
        ctx = ({k: torch.cat([cond[k], uncond[k]]) for k in cond}
               if doubled else cond)
        with torch.no_grad():
            got, want = den(x, t, ctx), nchw(x, t, ctx)
        diff = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        check(diff <= TOL_LAYOUT * scale, f'{family}: the channels-last '
              f'U-Net is {diff} from its NCHW twin, scale {scale}')
        profiles[f'{family}_batch_{B}'] = dict(dit_profile(
            {'channels_last': den, 'nchw_convs': nchw}, cond, uncond,
            latent_shape=shape, doubled=doubled),
            max_abs_diff_vs_nchw=diff, scale=scale)
        del nchw
    phase_done('unet_profile', t0, **profiles)

    t0 = time.perf_counter()
    profiles = {}
    for family, (den, cond, uncond, shape, doubled) in steps.items():
        q = int8[family]
        B = 2 if doubled else 1
        g = torch.Generator(device='cuda').manual_seed(7)
        x = torch.randn((B, *shape), generator=g, device='cuda')
        t = torch.full((B,), 500, device='cuda')
        ctx = ({k: torch.cat([cond[k], uncond[k]]) for k in cond}
               if doubled else cond)
        with torch.no_grad():
            want, got = den(x, t, ctx), q(x, t, ctx)
        rel = float((got - want).norm() / want.norm())
        check(bool(torch.isfinite(got).all()), f'{family}: int8 U-Net '
              f'output not finite')
        check(rel < 0.15, f'{family}: the int8 U-Net is {rel} relative '
              f'from bf16 (bound 0.15, tests/test_int8.py)')
        profiles[f'{family}_batch_{B}'] = dict(
            dit_profile({'bf16': den, 'int8': q}, cond, uncond,
                        latent_shape=shape, doubled=doubled),
            int8_rel_to_bf16=rel, first_level_conv=int8_conv_ms(B))
    phase_done('unet_int8_profile', t0, **profiles)
    return results


def int8_conv_ms(B, C=320, H=32, W=96):
    """The U-Net-320's first-level 3x3 conv (C → C over the rolled-out
    32 × 96 latent, batch ``B``), ms per call from CUDA events around 50
    back-to-back calls: ``Int8Conv`` whole (per-sample quantization,
    padding and im2col, ``torch._int_mm``, rescale), its ``_int_mm``
    alone on the same patches, and cuDNN's bf16 conv of the same shape in
    channels-last memory."""
    import torch
    import torch.nn.functional as F
    from ln3diff_tpu_torch.ops.int8 import (Int8Conv, im2col,
                                            quantize_per_sample)
    g = torch.Generator(device='cuda').manual_seed(12)
    w = torch.randn((C, C, 3, 3), generator=g, device='cuda') / (9 * C)**0.5
    conv = Int8Conv(C, C, 3, padding=1).cuda().load_weight(w)
    x = torch.randn((B, C, H, W), generator=g, device='cuda').to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    xq, _ = quantize_per_sample(x.permute(0, 2, 3, 1))
    patches = im2col(xq, 3, padding=1).reshape(B * H * W, C * 9)
    kq = conv.kernel_q.reshape(C, C * 9).t()
    wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    return dict(
        shape=[B, C, H, W], kernel=3,
        int8_conv_ms=events_ms(lambda: conv(x)),
        int_mm_ms=events_ms(lambda: torch._int_mm(patches, kq)),
        bf16_cudnn_ms=events_ms(lambda: F.conv2d(x, wb, padding=1)),
        ops=2 * B * H * W * C * C * 9)


def ffhq_fgbg_render(frames=24):
    """The fg/bg VAE at full width (``vae_preset('ffhq-fgbg')``, random
    weights from seed 0, the bf16 decoder of serving): decode one latent
    to (1, 3, 128, 128, 64) planes, cast to bf16, then a ``frames``-frame
    FFHQ orbit of 64² rays (``img_resolution`` 256 / ``sr_ratio`` 4) with
    the FFHQ render options (48+48 samples) and 16 background samples
    per ray, through ``SuperresolutionHybrid`` to 256², one frame per
    call.  Twice: the fg pass through kernel 1 (``use_fused_osg=True``),
    then through its plain version ``osg_pointwise_reference`` in the
    wrapper's place; the frames held together at ``TOL['bfloat16']``.
    ms per frame split into rays + kernel 1 (the fg pass), the bg pass and
    the SR head by synchronising timers; kernel 1's launches; peak
    memory."""
    import torch
    from ln3diff_tpu_torch.config import (CAMERA_PRESETS, RENDER_PRESETS,
                                          vae_preset)
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE
    from ln3diff_tpu_torch.ops import fused_render
    from ln3diff_tpu_torch.render import background
    from ln3diff_tpu_torch.render.camera import orbit_cameras

    cfg = vae_preset('ffhq-fgbg')
    with torch.device('cuda'):
        vae = TriplaneVAE(cfg)
    random_init_(vae, torch.Generator(device='cuda').manual_seed(0))
    vae.cast_decoder().eval()
    rays = cfg.img_resolution // cfg.sr_ratio
    opts = RENDER_PRESETS['ffhq']
    cams = torch.from_numpy(orbit_cameras(
        frames, **CAMERA_PRESETS['ffhq'])).float().cuda()
    latent = torch.randn((1, cfg.latent_size, cfg.latent_size,
                          cfg.latent_channels), device='cuda',
                         generator=torch.Generator(device='cuda')
                         .manual_seed(8))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        planes = vae.decode_latent(latent).to(torch.bfloat16)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(tuple(planes.shape) == (1, 3, 128, 128, 64),
          f'fgbg planes {tuple(planes.shape)}')
    check(bool(torch.isfinite(planes).all()), 'fgbg planes not finite')

    secs = {}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[key] = secs.get(key, 0.0) + time.perf_counter() - s0
            return out
        return run

    def orbit():
        secs.clear()
        outs = []
        with torch.no_grad():
            for i in range(frames):
                outs.append(timed('frame', vae.render)(
                    planes, cams[i:i + 1], opts, rays, use_fused_osg=True))
        return {k: torch.cat([o[k] for o in outs])
                for k in ('image_sr', 'image_raw', 'image_depth',
                          'image_mask')}

    render_bg = background.render_background
    kernel_1 = fused_render.osg_pointwise_fused
    background.render_background = timed('bg_pass', render_bg)
    vae.superresolution.forward = timed('sr_head',
                                        vae.superresolution.forward)
    res = {}
    try:
        runs = {}
        for route in ('kernel_1', 'plain'):
            if route == 'plain':
                fused_render.osg_pointwise_fused =                     fused_render.osg_pointwise_reference
            fused_render.FusedOSG.launches = 0
            orbit()                                   # warm-up
            fused_render.FusedOSG.launches = 0
            runs[route] = orbit()
            launches = fused_render.FusedOSG.launches
            want = 2 * frames if route == 'kernel_1' else 0
            check(launches == want, f'fgbg {route}: kernel 1 launched '
                  f'{launches} times, expected {want}')
            per = {k: secs[k] / frames * 1e3
                   for k in ('frame', 'bg_pass', 'sr_head')}
            per['rays_and_fg_pass'] = (per['frame'] - per['bg_pass']
                                       - per['sr_head'])
            res[route] = dict(ms_per_frame=per, fused_osg_launches=launches)
    finally:
        background.render_background = render_bg
        fused_render.osg_pointwise_fused = kernel_1
        del vae.superresolution.forward
    sr = runs['kernel_1']['image_sr']
    check(tuple(sr.shape) == (frames, 4 * rays, 4 * rays, 3),
          f'fgbg SR frames {tuple(sr.shape)}')
    atol, rtol = TOL['bfloat16']
    errs = {}
    for key, got in runs['kernel_1'].items():
        ref = runs['plain'][key]
        check(bool(torch.isfinite(got).all()), f'fgbg {key} not finite')
        err = (got - ref).abs()
        # the SR frames are unbounded: atol scales with their range
        a = atol * max(1.0, float(ref.abs().max())) if key == 'image_sr' \
            else atol
        errs[key] = float(err.max())
        check(bool((err <= a + rtol * ref.abs()).all()),
              f'fgbg {key}: kernel 1 vs plain max|Δ| {errs[key]}')
    raw = runs['kernel_1']['image_raw']
    res.update(decode_seconds=round(decode_s, 3), frames=frames,
               rays=rays, sr_side=4 * rays, max_abs_err_vs_plain=errs,
               atol=atol, rtol=rtol,
               frames_range=[float(raw.min()), float(raw.max())],
               sr_range=[float(sr.min()), float(sr.max())],
               peak_mem_gib=round(torch.cuda.max_memory_allocated()
                                  / 2**30, 3))
    return res


# -- the stage-2 latent-diffusion trainer (LDMTrainer, ControlNetTrainer)


def _ldm_trainer(cfg, objective, device, seed=0, **train_kw):
    """An ``LDMTrainer`` of ``DiT_TriLatent(cfg)`` on ``device`` whose
    weights are drawn by ``random_init_`` and then left non-zero (JAX's
    zero-initialised adaLN and final layer would give every block a zero
    grad at the first step)."""
    import torch
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.training.ldm_trainer import (LDMTrainConfig,
                                                        LDMTrainer)
    with torch.device(device):
        model = DiT_TriLatent(cfg)
    tr = LDMTrainer(model, LDMTrainConfig(objective=objective,
                                          log_interval=10**9, **train_kw),
                    seed=seed, device=device)
    random_init_(tr.model, torch.Generator(device=device).manual_seed(seed))
    return tr


def _ldm_draws(objective, B, shape, g, device):
    """t (the FM time, the DDPM step or the EDM σ index) and the noise of
    one step, drawn from the CPU generator ``g``."""
    import torch
    from ln3diff_tpu_torch.training.ldm_trainer import LDMDraws
    t = (torch.rand((B,), generator=g) if objective == 'flow_matching'
         else torch.randint(0, 1000, (B,), generator=g))
    return LDMDraws(t.to(device), torch.randn((B,) + shape,
                                              generator=g).to(device))


def _grads_of(tr, batch, draws):
    """(loss, {name: grad}) of one loss evaluation; no optimizer step."""
    import torch
    loss, _ = tr._loss_fn(None, None, batch, draws)
    loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad.detach())
             for k, p in tr.model.named_parameters()}
    tr.model.zero_grad(set_to_none=True)
    return loss.item(), grads


def small_ldm_train_reference():
    """One step of a small text DiT (depth 2, hidden 64) on the card and on
    the CPU for each objective — flow matching, DDPM with the
    learned-range variance head and the hybrid ``rescaled_mse`` loss, EDM
    — from the same weights, batch and draws, f32: the loss, every grad
    and the params after the AdamW step must agree (``TOL_LDM_TRAIN``)."""
    import torch
    from ln3diff_tpu_torch.models.dit import DiTConfig
    B, shape = 4, (8, 8, 12)
    res = {}
    for objective in ('flow_matching', 'ddpm', 'edm'):
        ddpm = objective == 'ddpm'
        cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4,
                        hidden_size=64, depth=2, num_heads=4, variant='text',
                        context_dim=32, learn_sigma=ddpm,
                        dtype=torch.float32)
        kw = dict(lr=2e-3, ema_rate=0.5)
        if ddpm:
            kw.update(var_type='learned_range', loss_type='rescaled_mse')
        cpu = _ldm_trainer(cfg, objective, 'cpu', seed=3, **kw)
        card = _ldm_trainer(cfg, objective, 'cuda', seed=3, **kw)
        card.model.load_state_dict(cpu.model.state_dict())
        g = torch.Generator().manual_seed(4)
        batch = {'latent': torch.randn((B,) + shape, generator=g),
                 'context': {'crossattn': torch.randn((B, 7, 32),
                                                      generator=g)}}
        draws = _ldm_draws(objective, B, shape, g, 'cpu')
        out = {}
        for name, tr in (('cpu', cpu), ('cuda', card)):
            dev = tr.device
            b = {'latent': batch['latent'].to(dev),
                 'context': {'crossattn': batch['context']['crossattn']
                             .to(dev)}}
            d = type(draws)(*(x.to(dev) for x in draws))
            loss, grads = _grads_of(tr, b, d)
            tr.train_step(b, draws=d)
            out[name] = dict(loss=loss, grads={k: v.cpu()
                                               for k, v in grads.items()},
                             params={k: p.detach().cpu() for k, p in
                                     tr.state.params.items()})
        lc, lg = out['cpu']['loss'], out['cuda']['loss']
        check(abs(lg - lc) <= TOL_LDM_TRAIN * abs(lc),
              f'{objective}: loss {lg} vs CPU {lc}')
        worst = _worst_grad(out['cuda']['grads'], out['cpu']['grads'],
                            TOL_LDM_TRAIN, objective)
        worst_step = _check_step(out['cuda']['params'], out['cpu']['params'],
                                 out['cpu']['grads'], TOL_LDM_TRAIN,
                                 kw['lr'], objective)
        res[objective] = dict(loss_cpu=lc, loss_cuda=lg,
                              loss_rel_err=abs(lg - lc) / abs(lc),
                              grad_err_in_units_of_tol=worst,
                              max_step_err_resolved=worst_step,
                              tensors=len(out['cpu']['grads']))
    return res


def _ldm_batch(B, seed, device='cuda'):
    """Latents (B, 32, 32, 12) and a CLIP-L context (B, 77, 768), standard
    normal from ``seed``."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    return {'latent': torch.randn((B, 32, 32, 12), generator=g,
                                  device=device),
            'context': {'crossattn': torch.randn((B, 77, 768), generator=g,
                                                 device=device)}}


def _train_step_profile(tr, batch, top=6):
    """One ``train_step`` under torch.profiler (CUDA activity): device
    kernel time, its share of the step's wall time, the launches and the
    largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, 'self_device_time_total', None) \
            or getattr(e, 'self_cuda_time_total', 0)
    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    if not events:
        return dict(device_ms=None, wall_ms=wall * 1e3)
    dev = sum(dev_us(e) for e in events) / 1e3
    return dict(device_ms=dev, wall_ms=wall * 1e3,
                busy_share=dev / (wall * 1e3),
                kernel_launches=sum(e.count for e in events),
                top_kernels=[dict(name=e.key[:80], ms=dev_us(e) / 1e3,
                                  calls=e.count)
                             for e in sorted(events, key=dev_us,
                                             reverse=True)[:top]])


def ldm_train(steps=5, warmup=2, B=8):
    """The stage-2 trainer at the released width: ``denoiser_preset(
    't23d-dit-l2')`` (DiT-L/2, 24 blocks of 1024) with ``remat=True,
    remat_policy='dots'``, bf16 autocast over f32 parameters, AdamW lr
    1e-4, clip 0.5, EMA 0.9999, latents (8, 32, 32, 12) and a (8, 77, 768)
    context from seed 0, as ``scripts/scripts_lib/bench_train_steps.py``
    ``dit_step`` sets it up.  Two routes: 'ddpm' (the t23d release's
    objective: v-prediction, fixed-small variance, MSE) and
    'flow_matching' (the objective ``dit_step`` times), built one after
    the other (peak memory above what was resident before each) and
    warmed up (``warmup`` steps), then ``steps`` steps each in turns
    (host clock, synchronised per step) and one profiled step each.
    Checks: finite losses, every parameter tensor moved, the EMA lags the
    params.  Then one loss evaluation of the 'dots' model and of a twin
    without remat on the same weights, batch and draws: their grads agree
    (``TOL_REMAT``); both peak memories above resident and both host-clock
    times of that evaluation are printed.  Returns the
    result and the flow-matching model for ``edm_sample``."""
    import torch
    from ln3diff_tpu_torch.config import denoiser_preset
    cfg = dataclasses.replace(denoiser_preset('t23d-dit-l2'), remat=True,
                              remat_policy='dots')
    batch = _ldm_batch(B, 0)
    trainers, res, init = {}, {}, {}
    for route in ('ddpm', 'flow_matching'):
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = _ldm_trainer(cfg, route, 'cuda', seed=0, lr=1e-4)
        tr.generator = torch.Generator(device='cuda').manual_seed(1)
        init[route] = {k: p.detach().clone()
                       for k, p in tr.model.named_parameters()}
        losses = []
        for _ in range(warmup):
            losses.append(float(tr.train_step(batch)['loss']))
        torch.cuda.synchronize()
        res[route] = dict(
            peak_mem_above_resident_gib=round(
                (torch.cuda.max_memory_allocated() - resident) / 2**30, 3),
            resident_gib=round((torch.cuda.memory_allocated() - resident)
                               / 2**30, 3),
            params=sum(p.numel() for p in tr.model.parameters()),
            losses=losses, secs=[])
        trainers[route] = tr
    order = (['ddpm', 'flow_matching', 'flow_matching', 'ddpm']
             * steps)[:2 * steps]
    for route in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainers[route].train_step(batch)
        torch.cuda.synchronize()
        res[route]['secs'].append(time.perf_counter() - t0)
        res[route]['losses'].append(float(m['loss']))
    for route, tr in trainers.items():
        r = res[route]
        r['profile'] = _train_step_profile(tr, batch)
        check(all(math.isfinite(x) for x in r['losses']),
              f'ldm {route}: non-finite loss {r["losses"]}')
        p0 = init.pop(route)
        ema = tr.state.ema_params['ema']
        not_moved = [k for k, p in tr.state.params.items()
                     if torch.equal(p, p0[k])]
        check(not not_moved, f'ldm {route}: {len(not_moved)} tensors did '
              f'not move, e.g. {not_moved[:3]}')
        d_param = math.sqrt(sum(float(((p.detach() - p0[k])**2).sum())
                                for k, p in tr.state.params.items()))
        d_ema = math.sqrt(sum(float(((ema[k] - p0[k])**2).sum())
                              for k in ema))
        check(0 < d_ema < d_param, f'ldm {route}: the EMA moved {d_ema}, '
              f'the params {d_param}')
        del p0
        r.update(s_per_step=sum(r['secs']) / len(r['secs']),
                 s_per_step_runs=r.pop('secs'),
                 ema_to_param_distance_ratio=d_ema / d_param)
    res['timed_order'] = order

    # remat 'dots' against no remat, on the ddpm route's weights
    fm_model = trainers.pop('flow_matching').model
    tr = trainers.pop('ddpm')
    twin = _ldm_trainer(dataclasses.replace(cfg, remat=False), 'ddpm',
                        'cuda', seed=0)
    twin.model.load_state_dict(tr.model.state_dict())
    draws = _ldm_draws('ddpm', B, (32, 32, 12),
                       torch.Generator().manual_seed(2), 'cuda')
    cmp = {}
    for name, t in (('dots', tr), ('none', twin)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = _grads_of(t, batch, draws)
        torch.cuda.synchronize()
        cmp[name] = dict(loss=loss, grads=grads, secs=time.perf_counter() - t0,
                         peak=round((torch.cuda.max_memory_allocated()
                                     - resident) / 2**30, 3))
    gmax = max(float(g.abs().max()) for g in cmp['none']['grads'].values())
    worst = 0.0
    for k, want in cmp['none']['grads'].items():
        tol = max(TOL_REMAT * float(want.abs().max()), 1e-5 * gmax)
        err = float((cmp['dots']['grads'][k] - want).abs().max())
        worst = max(worst, err / tol)
        check(err <= tol, f'remat dots vs none: grad of {k} max|Δ| {err} '
              f'> {tol}')
    res['remat_check'] = dict(
        loss_dots=cmp['dots']['loss'], loss_none=cmp['none']['loss'],
        grad_err_in_units_of_tol=worst,
        peak_mem_gib_loss_and_grads={'dots': cmp['dots']['peak'],
                                     'none': cmp['none']['peak']},
        seconds_loss_and_grads={'dots': cmp['dots']['secs'],
                                'none': cmp['none']['secs']})
    del cmp, tr, twin
    torch.cuda.empty_cache()
    return res, fm_model


def controlnet_train(steps=3, B=2):
    """``ControlNetTrainer`` over the ShapeNet U-Net-320
    (``denoiser_preset('shapenet-unet')``, random weights from seed 0,
    bf16 autocast over f32 parameters) and its ControlNet (the trainer's
    init: zero convs at zero), DDPM objective, batch 2: latents (2, 32, 32,
    12), 256² hints (tiled over the three rolled-out planes), a (2, 77,
    768) context; ``steps`` steps.  Every U-Net parameter must be bit for
    bit unchanged and the ControlNet's parameters must have moved."""
    import torch
    from ln3diff_tpu_torch.config import denoiser_preset
    from ln3diff_tpu_torch.models.controlnet import ControlNet
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.unet import UNetModel
    from ln3diff_tpu_torch.training.ldm_trainer import (ControlNetTrainer,
                                                        LDMTrainConfig)
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = denoiser_preset('shapenet-unet')
    with torch.device('cuda'):
        unet, cn = UNetModel(cfg), ControlNet(cfg)
    random_init_(unet, torch.Generator(device='cuda').manual_seed(0))
    tr = ControlNetTrainer(unet, cn, LDMTrainConfig(
        objective='ddpm', lr=1e-4, log_interval=10**9), seed=0,
        device='cuda')
    frozen = {k: p.detach().clone() for k, p in unet.named_parameters()}
    before = {k: p.detach().clone() for k, p in cn.named_parameters()}
    batch = _ldm_batch(B, 3)
    g = torch.Generator(device='cuda').manual_seed(4)
    batch['hint'] = torch.rand((B, 256, 256, 3), generator=g,
                               device='cuda') * 2 - 1
    secs, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m['loss']))
    check(all(math.isfinite(x) for x in losses), f'cldm losses {losses}')
    changed = [k for k, p in unet.named_parameters()
               if not torch.equal(p, frozen[k])]
    check(not changed, f'the frozen U-Net moved: {changed[:3]}')
    moved = sum(not torch.equal(p, before[k])
                for k, p in cn.named_parameters())
    check(moved > 0, 'the ControlNet did not move')
    res = dict(losses=losses, s_per_step_runs=secs,
               unet_params=sum(p.numel() for p in unet.parameters()),
               controlnet_params=sum(p.numel() for p in cn.parameters()),
               controlnet_tensors_moved=moved,
               controlnet_tensors=len(before),
               peak_mem_gib=round((torch.cuda.max_memory_allocated()
                                   - resident) / 2**30, 3))
    del tr, unet, cn, frozen, before
    torch.cuda.empty_cache()
    return res


def edm_sample(model, steps=25):
    """``euler_edm_sample`` through the DiT-L/2 of ``ldm_train`` (eps
    scaling over the discrete σ table; the network takes the σ index as
    its t) with the CFG-doubled batch, 25 steps, CFG 6.5, bf16 autocast:
    the output must be finite; host-clock ms per step."""
    import torch
    from ln3diff_tpu_torch.diffusion.edm import (DiscreteDenoiser,
                                                 euler_edm_sample)

    def network(x, c_noise, cond):
        with torch.autocast('cuda', dtype=torch.bfloat16):
            return model(x, c_noise.float(), cond)

    g = torch.Generator(device='cuda').manual_seed(5)
    cond = {'crossattn': torch.randn((1, 77, 768), generator=g,
                                     device='cuda')}
    uc = {'crossattn': torch.zeros_like(cond['crossattn'])}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = euler_edm_sample(DiscreteDenoiser(), network, (1, 32, 32, 12), cond,
                         uc, num_steps=steps, cfg_scale=6.5, device='cuda',
                         generator=g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tuple(x.shape) == (1, 32, 32, 12), 'edm sample shape')
    check(bool(torch.isfinite(x).all()), 'edm sample not finite')
    return dict(steps=steps, seconds=wall, ms_per_step=wall * 1e3 / steps,
                abs_max=float(x.abs().max()))


# -- the LSGM joint trainer and the adversarial VAE trainer ----------------

def _small_lsgm(device, lsgm_kw, seed=3):
    """A small ``LSGMTrainer`` (the small VAE of ``_train_cfgs`` and a
    U-Net of 32 channels with the spatial transformer over a (7, 32)
    context, roll-out, mixed prediction), f32, lr 2e-3, EMA 0.5."""
    import torch
    from ln3diff_tpu_torch.models.unet import UNetConfig, UNetModel
    from ln3diff_tpu_torch.training.losses import LossConfig
    from ln3diff_tpu_torch.training.lsgm_trainer import (LSGMConfig,
                                                         LSGMTrainConfig,
                                                         LSGMTrainer)
    model_cfg, _, _, opts = _train_cfgs(small=True)
    with torch.device(device):
        unet = UNetModel(UNetConfig(
            in_channels=4, model_channels=32, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2, context_dim=32, use_spatial_transformer=True,
            roll_out=True, mixed_prediction=True, dtype=torch.float32))
    return LSGMTrainer(
        model_cfg, unet, LSGMTrainConfig(lr=2e-3, ema_rate=0.5,
                                         patch_resolution=16,
                                         render_resolution=32,
                                         log_interval=10**9),
        LossConfig(lpips_lambda=0.0, l1_lambda=0.3), LSGMConfig(**lsgm_kw),
        render_opts=opts, seed=seed, device=device)


def _to(tree, device):
    """Tensors (in tuples, NamedTuples, dicts and AugmentDraws) on
    ``device``."""
    import torch
    from ln3diff_tpu_torch.training.augment import AugmentDraws
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, AugmentDraws):
        return AugmentDraws({k: v.to(device) for k, v in tree.values.items()})
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if hasattr(tree, '_fields'):
        return type(tree)(*(_to(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _grads(module):
    """{name: grad on the CPU} (zeros where None), then clears them."""
    import torch
    out = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
           .detach().cpu() for k, p in module.named_parameters()
           if p.requires_grad}
    module.zero_grad(set_to_none=True)
    return out


def _worst_grad(got, want, tol, what):
    """max over tensors of max|Δ| / (tol·scale, floor 1e-5 of the largest
    grad), in units of ``tol``; fails above 1."""
    gmax = max(float(v.abs().max()) for v in want.values())
    worst = 0.0
    check(sorted(got) == sorted(want), f'{what}: other grad names')
    for k, w in want.items():
        bound = max(tol * float(w.abs().max()), 1e-5 * gmax)
        err = float((got[k] - w).abs().max())
        worst = max(worst, err / bound)
        check(err <= bound, f'{what}: grad of {k}: card vs CPU max|Δ| '
              f'{err} > {bound}')
    return worst


def _check_step(p_card, p_cpu, grads_cpu, tol, lr, what):
    """After one AdamW step from the same weights: every weight within
    2·lr, and within 1e-5 of scale plus 1e-2·lr where its grad is
    resolved (10× the grad's bound); returns the largest resolved
    difference."""
    gmax = max(float(v.abs().max()) for v in grads_cpu.values())
    worst = 0.0
    for k, want in grads_cpu.items():
        perr = (p_card[k] - p_cpu[k]).abs()
        check(float(perr.max()) <= 2 * lr + 1e-6,
              f'{what}: {k}: step off by more than 2·lr')
        resolved = want.abs() >= 10 * max(tol * float(want.abs().max()),
                                          1e-5 * gmax)
        ptol = 1e-5 * float(p_cpu[k].abs().max()) + 1e-2 * lr
        check(bool((perr[resolved] <= ptol).all()),
              f'{what}: {k}: the AdamW step differs where the grad is '
              f'resolved')
        if resolved.any():
            worst = max(worst, float(perr[resolved].max()))
    return worst


def small_lsgm_train_reference():
    """One joint LSGM step (``_small_lsgm``) on the card and on the CPU
    from the same weights (the U-Net redrawn off JAX's zero output conv,
    its mixing logit at 0 so that the U-Net's share is one half), batch
    and draws, under ``LSGMConfig()`` and ``p_rendering_loss=True``: the
    loss, each metric, every grad and the step (``TOL_LSGM_TRAIN``).
    Returns the results and the card's trainer of the default config for
    ``lsgm_checkpoint``."""
    import numpy as np
    import torch
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.render.renderer import draw_uniforms
    from ln3diff_tpu_torch.training.lsgm_trainer import LSGMDraws
    raw = make_multiview_batch(2, 32, 32, seed=5)
    raw['context'] = np.random.default_rng(6).standard_normal(
        (1, 7, 32)).astype(np.float32)
    res, keep = {}, None
    for case, kw in (('default', {}), ('p_rendering', dict(
            p_rendering_loss=True))):
        cpu = _small_lsgm('cpu', kw)
        random_init_(cpu.denoiser, torch.Generator().manual_seed(7))
        with torch.no_grad():
            cpu.denoiser.mixing_logit.zero_()
        card = _small_lsgm('cuda', kw)
        card.joint.load_state_dict(cpu.joint.state_dict())
        g = torch.Generator().manual_seed(4)
        lat = (1, 16, 16, 12)
        draws = LSGMDraws(torch.randn((1, 16, 16, 4, 3), generator=g),
                          draw_uniforms(2, 16**2, cpu.render_opts, g, 'cpu'),
                          torch.rand((1,), generator=g),
                          torch.randn(lat, generator=g),
                          torch.rand((1,), generator=g),
                          torch.randn(lat, generator=g))
        out = {}
        for name, tr in (('cpu', cpu), ('cuda', card)):
            d = _to(draws, tr.device)
            batch = tr.prepare_batch(raw)
            tr.build()
            loss, metrics = tr.loss_fn(None, None, batch, d)
            loss.backward()
            out[name] = dict(loss=loss.item(), grads=_grads(tr.joint),
                             metrics={k: float(v.detach()) for k, v in
                                      metrics.items()})
            tr.train_step(batch, draws=d)
            out[name]['params'] = {k: p.detach().cpu() for k, p in
                                   tr.state.params.items()}
        lc, lg = out['cpu']['loss'], out['cuda']['loss']
        check(abs(lg - lc) <= TOL_LSGM_TRAIN * abs(lc),
              f'lsgm {case}: loss {lg} vs CPU {lc}')
        for k, v in out['cpu']['metrics'].items():
            w = out['cuda']['metrics'][k]
            check(abs(w - v) <= TOL_LSGM_TRAIN * max(abs(v), 1e-3),
                  f'lsgm {case}: {k} {w} vs CPU {v}')
        worst = _worst_grad(out['cuda']['grads'], out['cpu']['grads'],
                            TOL_LSGM_TRAIN, f'lsgm {case}')
        step = _check_step(out['cuda']['params'], out['cpu']['params'],
                           out['cpu']['grads'], TOL_LSGM_TRAIN, 2e-3,
                           f'lsgm {case}')
        unet_g = max(float(v.abs().max()) for k, v in
                     out['cpu']['grads'].items() if k.startswith('ddpm.'))
        check(unet_g > 0, f'lsgm {case}: the U-Net got no grad')
        res[case] = dict(loss_cpu=lc, loss_cuda=lg,
                         loss_rel_err=abs(lg - lc) / abs(lc),
                         metrics_cuda=out['cuda']['metrics'],
                         grad_err_in_units_of_tol=worst,
                         max_step_err_resolved=step,
                         tensors=len(out['cpu']['grads']))
        if case == 'default':
            keep = card
    return res, keep


def lsgm_checkpoint(trainer):
    """The card's LSGM train state through ``CheckpointManager``: saved
    at two steps (retention 1), restored into a second trainer drawn from
    another seed; every parameter, EMA and AdamW moment tensor and the
    step equal bit for bit."""
    import torch
    from ln3diff_tpu_torch.training.checkpoint import CheckpointManager
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, max_to_keep=1)
        mgr.save(0, trainer.state)
        t0 = time.perf_counter()
        mgr.save(int(trainer.state.step), trainer.state)
        save_s = time.perf_counter() - t0
        check(mgr.all_steps() == [int(trainer.state.step)],
              f'retention kept {mgr.all_steps()}')
        nbytes = os.path.getsize(os.path.join(
            d, str(mgr.latest_step()), 'state.pt'))
        twin = _small_lsgm('cuda', {}, seed=11)
        twin.init_state()
        t0 = time.perf_counter()
        mgr.restore(twin.state)
        restore_s = time.perf_counter() - t0
    a, b = trainer.state, twin.state
    pairs = [(a.params, b.params)] + [
        (a.ema_params[n], b.ema_params[n]) for n in a.ema_params] + [
        (a.opt_state[m], b.opt_state[m]) for m in ('mu', 'nu')]
    n = 0
    for x, y in pairs:
        for k, v in x.items():
            check(y[k].device.type == 'cuda', f'{k} restored off the card')
            check(torch.equal(v, y[k]), f'checkpoint: {k} differs')
            n += 1
    check(b.step == a.step and b.opt_state['count'] ==
          a.opt_state['count'], 'checkpoint: step or count differs')
    return dict(tensors=n, bytes=nbytes, save_s=save_s, restore_s=restore_s,
                step=int(b.step))


def lsgm_train(steps=3, warmup=2):
    """The LSGM joint step at full width: ``vae_preset('objaverse')`` (bf16
    over f32 parameters; 4 views of 256², patch 32 of a 128² render, 64+64
    samples) with the U-Net-320 of ``scripts/vit_triplane_diffusion_
    train.py`` (``UNetConfig(in_channels=4, out_channels=4,
    model_channels=320)``: roll-out, mixed prediction, the spatial
    transformer over a (77, 768) context; bf16 autocast), one instance,
    ``LSGMConfig()``, one AdamW (lr 1e-4, clip 0.5) and EMA over both
    trees; weights from seed 0 (the U-Net redrawn off JAX's zero output
    conv).  ``warmup`` steps, then ``steps`` timed steps (host clock,
    synchronised) and one profiled step; resident memory after the state
    is built and the peak above it."""
    import numpy as np
    import torch
    from ln3diff_tpu_torch.config import RENDER_PRESETS, vae_preset
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.unet import UNetConfig, UNetModel
    from ln3diff_tpu_torch.training.losses import LossConfig
    from ln3diff_tpu_torch.training.lsgm_trainer import (LSGMConfig,
                                                         LSGMTrainConfig,
                                                         LSGMTrainer)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with torch.device('cuda'):
        unet = UNetModel(UNetConfig(in_channels=4, out_channels=4,
                                    model_channels=320))
    tr = LSGMTrainer(
        vae_preset('objaverse'), unet,
        LSGMTrainConfig(lr=1e-4, patch_resolution=32, render_resolution=128,
                        log_interval=10**9),
        LossConfig(depth_lambda=0.5, lpips_lambda=0.0), LSGMConfig(),
        render_opts=RENDER_PRESETS[
            'objverse_tuneray_aug_resolution_64_64_auto'],
        seed=0, device='cuda')
    random_init_(tr.denoiser, torch.Generator(device='cuda').manual_seed(1))
    tr.generator = torch.Generator(device='cuda').manual_seed(2)
    tr.build()
    resident = torch.cuda.memory_allocated() - base
    raw = make_multiview_batch(4, 256, 128, seed=0)
    raw['context'] = np.random.default_rng(3).standard_normal(
        (1, 77, 768)).astype(np.float32)
    sums0 = {k: float(p.detach().double().abs().sum())
             for k, p in tr.state.params.items()}
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for i in range(warmup + steps):
        batch = tr.prepare_batch(raw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            secs.append(time.perf_counter() - t0)
        losses.append(float(m['loss']))
    peak = torch.cuda.max_memory_allocated() - base - resident
    last = {k: float(v) for k, v in m.items()}
    profile = _train_step_profile(tr, tr.prepare_batch(raw))
    check(all(math.isfinite(x) for x in losses), f'lsgm losses {losses}')
    moved = {'vae': 0, 'ddpm': 0}
    for k, p in tr.state.params.items():
        if float(p.detach().double().abs().sum()) != sums0[k]:
            moved[k.split('.', 1)[0]] += 1
    check(moved['vae'] > 0 and moved['ddpm'] > 0,
          f'lsgm: tensors moved per tree {moved}')
    n_vae = sum(p.numel() for p in tr.vae.parameters())
    n_unet = sum(p.numel() for p in tr.denoiser.parameters())
    res = dict(s_per_step=sum(secs) / len(secs), s_per_step_runs=secs,
               losses=losses, last_metrics=last,
               vae_params=n_vae, unet_params=n_unet,
               tensors_moved=moved, tensors=len(sums0),
               resident_gib=round(resident / 2**30, 3),
               peak_above_resident_gib=round(peak / 2**30, 3),
               profile=profile)
    del tr, unet, batch, m
    torch.cuda.empty_cache()
    return res


def _aug_draws(shape, g):
    """``AugmentDraws`` of a ``bgc_config()`` call on ``shape`` from the
    CPU generator ``g``."""
    import torch
    from ln3diff_tpu_torch.training.augment import (AugmentDraws,
                                                    augment_draw_plan,
                                                    bgc_config)
    return AugmentDraws({
        i: (torch.rand if kind == 'uniform' else torch.randn)(
            shp, generator=g)
        for i, kind, shp in augment_draw_plan(shape, bgc_config())})


def small_adv_train_reference():
    """The small VAE (``_train_cfgs``) with LPIPS in the loss and an
    ``AdversarialHead`` (a 16² StyleGAN discriminator, R1 γ 1, ADA
    ``bgc_config()`` at p = 0.6) on the card with ``use_fused_osg=True``
    and on the CPU with the plain versions, from the same weights, batch
    and draws, f32: the VAE step's loss and grads, then the discriminator
    step's inputs (a re-render), loss and grads (R1's double backward,
    the augmentation's draws given) and its AdamW step; then one step with
    a ``VisionAidedHead`` (a toy CLIP tower): its VAE grads and the
    heads' grads.  The card run must launch kernels 1 and 2 in the VAE
    step and kernel 1 in the re-render; the CPU run none."""
    import torch
    from ln3diff_tpu_torch.conditioning.clip import CLIPVisionConfig
    from ln3diff_tpu_torch.conditioning.lpips import make_lpips_fn
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.models.stylegan import DiscriminatorConfig
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.render.renderer import draw_uniforms
    from ln3diff_tpu_torch.training.augment import bgc_config
    from ln3diff_tpu_torch.training.gan import AdversarialHead, GANConfig
    from ln3diff_tpu_torch.training.vae_trainer import TrainDraws, VAETrainer
    from ln3diff_tpu_torch.training.vision_aided import (VisionAidedConfig,
                                                         VisionAidedHead)
    model_cfg, train_cfg, loss_cfg, opts = _train_cfgs(small=True)
    loss_cfg = dataclasses.replace(loss_cfg, lpips_lambda=0.5)
    gan_cfg = GANConfig(disc=DiscriminatorConfig(
        img_resolution=16, base_channels=16, max_channels=64),
        ada=bgc_config())
    va_cfg = VisionAidedConfig(clip=CLIPVisionConfig(
        hidden_size=64, num_layers=4, num_heads=2, intermediate_size=128,
        patch_size=8, image_size=32), taps=(2, 4), head_width=16)
    raw = make_multiview_batch(2, 32, 32, seed=5)
    g = torch.Generator().manual_seed(4)
    shape = (2, 16, 16, 3)
    draws = TrainDraws(torch.randn((1, 16, 16, 4, 3), generator=g),
                       draw_uniforms(2, 16**2, opts, g, 'cpu'),
                       _aug_draws(shape, g))
    d_draws = (_aug_draws(shape, g), _aug_draws(shape, g))
    nets, out = {}, {}
    for name, fused in (('cpu', False), ('cuda', True)):
        head = AdversarialHead(gan_cfg, seed=3, device=name)
        head.ada_p = 0.6
        lpips = make_lpips_fn(device=name, seed=3)
        va = VisionAidedHead(va_cfg, seed=3, device=name)
        tr = VAETrainer(model_cfg, dataclasses.replace(
            train_cfg, use_fused_osg=fused), loss_cfg, render_opts=opts,
            seed=3, lpips_fn=lpips, adversarial=head, device=name)
        nets[name] = (tr.model, head.model, lpips.model, va.model)
        if name == 'cpu':
            # the CPU's initial weights (its step below changes them)
            init = [{k: v.clone() for k, v in n.state_dict().items()}
                    for n in nets['cpu']]
        else:
            for net, sd in zip(nets['cuda'], init):
                net.load_state_dict(sd)
        dev = tr.device
        batch = tr.prepare_batch(raw)
        o = out[name] = {}
        FusedOSG.launches = FusedOSG.backward_launches = 0
        loss, terms = tr.loss_fn(batch, draws=_to(draws, dev))
        loss.backward()
        o.update(loss=loss.item(), g_adv=float(terms['g_adv'].detach()),
                 lpips=float(terms['lpips'].detach()),
                 grads=_grads(tr.model))
        check(all(p.grad is None for p in head.model.parameters()),
              f'{name}: the generator term trained the discriminator')
        tr.train_step(batch, draws=_to(draws, dev))
        o['params'] = {k: p.detach().cpu() for k, p in
                       tr.state.params.items()}
        o['g_launches'] = (FusedOSG.launches, FusedOSG.backward_launches)
        real, fake = tr._disc_inputs(batch)
        o['d_launches'] = (FusedOSG.launches - o['g_launches'][0],
                           FusedOSG.backward_launches - o['g_launches'][1])
        o['fake'] = fake.cpu()
        d_loss, d_m = head.d_loss(real, fake, _to(d_draws, dev))
        d_loss.backward()
        o.update(d_loss=d_loss.item(), r1=float(d_m['r1'].detach()),
                 d_grads=_grads(head.model))
        head.disc_step(real, fake, _to(d_draws, dev))
        o['d_params'] = {k: p.detach().cpu() for k, p in
                         head.state.params.items()}
        tr.adversarial = va
        loss, terms = tr.loss_fn(batch, draws=_to(draws._replace(adv=None),
                                                  dev))
        loss.backward()
        o.update(va_loss=loss.item(), va_grads=_grads(tr.model))
        v_loss, _ = va.d_loss(real, fake)
        v_loss.backward()
        o.update(va_d_loss=v_loss.item(), va_d_grads=_grads(va.model))
    c, k = out['cpu'], out['cuda']
    check(c['g_launches'] == (0, 0) and c['d_launches'] == (0, 0),
          'the CPU run launched kernels')
    check(k['g_launches'][0] > 0 and k['g_launches'][1] > 0,
          f'the card VAE step launched {k["g_launches"]}')
    check(k['d_launches'][0] > 0 and k['d_launches'][1] == 0,
          f'the card re-render launched {k["d_launches"]}')
    for key in ('loss', 'g_adv', 'lpips', 'd_loss', 'r1', 'va_loss',
                'va_d_loss'):
        check(abs(k[key] - c[key]) <= TOL_ADV_TRAIN * max(abs(c[key]), 1e-3),
              f'adv {key}: card {k[key]} vs CPU {c[key]}')
    fake_err = float((k['fake'] - c['fake']).abs().max())
    check(fake_err <= TOL_ADV_TRAIN * max(1.0, float(c['fake'].abs().max())),
          f'adv re-render: card vs CPU max|Δ| {fake_err}')
    worst = {w: _worst_grad(k[w], c[w], TOL_ADV_TRAIN, f'adv {w}')
             for w in ('grads', 'd_grads', 'va_grads', 'va_d_grads')}
    step = _check_step(k['params'], c['params'], c['grads'], TOL_ADV_TRAIN,
                       train_cfg.lr, 'adv VAE')
    d_step = _check_step(k['d_params'], c['d_params'], c['d_grads'],
                         TOL_ADV_TRAIN, gan_cfg.disc_lr, 'adv D')
    return dict(
        {f'{key}_cpu': c[key] for key in ('loss', 'g_adv', 'd_loss', 'r1',
                                          'va_loss', 'va_d_loss')},
        **{f'{key}_cuda': k[key] for key in ('loss', 'g_adv', 'd_loss', 'r1',
                                             'va_loss', 'va_d_loss')},
        grad_err_in_units_of_tol=worst, max_step_err_resolved=step,
        max_d_step_err_resolved=d_step, rerender_max_abs_err=fake_err,
        vae_step_launches=dict(fused_osg=k['g_launches'][0],
                               fused_osg_bwd=k['g_launches'][1]),
        rerender_launches=dict(fused_osg=k['d_launches'][0],
                               fused_osg_bwd=k['d_launches'][1]))


def adv_vae_train(steps=3, warmup=2):
    """The adversarial VAE trainer at full width: ``train/objaverse-vae``
    (``_train_cfgs``'s VAE, render options and trainer settings) with
    ``use_fused_osg=True``, ``LossConfig()`` and ``make_lpips_fn()`` (a
    random VGG16) as ``lpips_fn``, and
    ``AdversarialHead(GANConfig(disc=DiscriminatorConfig(img_resolution=
    32)))`` as ``scripts/vit_triplane_cvD_train.py`` builds it; weights
    from seed 0.  ``warmup`` steps, then ``steps`` timed steps, each the
    VAE (generator) step and the discriminator step (host clock,
    synchronised apart), with the launches of kernels 1 and 2 per step;
    peak memory above what was resident before the phase.  Then one step
    with a ``VisionAidedHead`` (CLIP ViT-B/32 at 224², f32)."""
    import torch
    from ln3diff_tpu_torch.conditioning.lpips import make_lpips_fn
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.models.stylegan import DiscriminatorConfig
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.training.gan import AdversarialHead, GANConfig
    from ln3diff_tpu_torch.training.losses import LossConfig
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainer
    from ln3diff_tpu_torch.training.vision_aided import (VisionAidedConfig,
                                                         VisionAidedHead)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model_cfg, train_cfg, _, opts = _train_cfgs(small=False)
    head = AdversarialHead(GANConfig(disc=DiscriminatorConfig(
        img_resolution=32)), seed=0, device='cuda')
    tr = VAETrainer(model_cfg, dataclasses.replace(
        train_cfg, use_fused_osg=True), LossConfig(), render_opts=opts,
        seed=0, lpips_fn=make_lpips_fn(), adversarial=head, device='cuda')
    raw = make_multiview_batch(4, 256, 128, seed=0)
    gen = torch.Generator(device='cuda').manual_seed(1)
    g_secs, d_secs, losses, d_losses, launches = [], [], [], [], []
    for i in range(warmup + steps):
        batch = tr.prepare_batch(raw)
        batch['step'] = float(i)
        n0 = (FusedOSG.launches, FusedOSG.backward_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n1 = (FusedOSG.launches, FusedOSG.backward_launches)
        d = tr._disc_step(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        n2 = (FusedOSG.launches, FusedOSG.backward_launches)
        losses.append(float(m['loss']))
        d_losses.append(float(d['d_total']))
        if i >= warmup:
            g_secs.append(t1 - t0)
            d_secs.append(t2 - t1)
            launches.append(dict(
                generator_step=[n1[0] - n0[0], n1[1] - n0[1]],
                disc_step=[n2[0] - n1[0], n2[1] - n1[1]]))
    peak = torch.cuda.max_memory_allocated() - base
    check(all(math.isfinite(x) for x in losses + d_losses),
          f'adv losses {losses} {d_losses}')
    check(all(x['generator_step'][0] > 0 and x['generator_step'][1] > 0
              and x['disc_step'][0] > 0 and x['disc_step'][1] == 0
              for x in launches), f'adv launches {launches}')
    check(math.isfinite(float(m['g_adv'])) and float(m['lpips']) > 0,
          'adv: no generator term or no LPIPS term')
    res = dict(generator_s_per_step=sum(g_secs) / len(g_secs),
               disc_s_per_step=sum(d_secs) / len(d_secs),
               generator_s_runs=g_secs, disc_s_runs=d_secs,
               losses=losses, d_total=d_losses,
               g_adv=float(m['g_adv']), lpips=float(m['lpips']),
               r1=float(d['r1']), launches_per_step=launches[-1],
               fused_osg_launches=sum(x['generator_step'][0]
                                      + x['disc_step'][0] for x in launches),
               fused_osg_backward_launches=sum(x['generator_step'][1]
                                               for x in launches),
               disc_params=sum(p.numel() for p in head.model.parameters()),
               peak_mem_gib=round(peak / 2**30, 3))
    # one step with the vision-aided head (CLIP ViT-B/32)
    va = VisionAidedHead(VisionAidedConfig(), seed=0, device='cuda')
    tr.adversarial = va
    batch = tr.prepare_batch(raw)
    batch['step'] = float(warmup + steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = tr.train_step(batch, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d = tr._disc_step(batch)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(math.isfinite(float(m['loss'])) and math.isfinite(
        float(d['d_loss'])), 'vision-aided step not finite')
    res['vision_aided'] = dict(
        generator_s=t1 - t0, disc_s=t2 - t1, loss=float(m['loss']),
        g_adv=float(m['g_adv']), d_loss=float(d['d_loss']),
        trainable_params=sum(p.numel() for p in va.state.params.values()),
        frozen_params=sum(p.numel() for p in va.model.parameters()
                          if not p.requires_grad),
        peak_mem_gib=round((torch.cuda.max_memory_allocated() - base)
                           / 2**30, 3))
    del tr, head, va, batch, m, d
    torch.cuda.empty_cache()
    return res


# -- the EG3D warm-up, the 'lgm' encoder and StyleGAN3 -----------------------



def kernel_launches():
    """The four kernels' launch counters."""
    from ln3diff_tpu_torch.ops.fused_attention import (FusedAttention,
                                                       FusedQKVAttention)
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    return dict(fused_osg=FusedOSG.launches,
                fused_osg_bwd=FusedOSG.backward_launches,
                fused_attention=FusedAttention.launches,
                fused_qkv_attention=FusedQKVAttention.launches)


def zero_kernel_launches():
    from ln3diff_tpu_torch.ops.fused_attention import (FusedAttention,
                                                       FusedQKVAttention)
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    FusedOSG.launches = FusedOSG.backward_launches = 0
    FusedAttention.launches = FusedQKVAttention.launches = 0


def no_kernel_launches(phase):
    """The counters after a path on which the JAX package runs no Pallas
    kernel: all four must read 0."""
    counts = kernel_launches()
    check(not any(counts.values()), f'{phase}: kernels launched {counts}')
    return counts


def _small_warmup(device, seed=3):
    """A small ``EG3DWarmupTrainer``: a toy ``FFHQVAE`` (a 2-block ViT at
    56², the v3 fusion decoder over 4² tokens, 32² planes of 8 channels,
    the 8XDC head's ``sr_ws``) under a teacher with w 512 and 32² planes,
    f32, batch 2, 16² renders with 8+8 samples, lr 2e-3, EMA 0.5."""
    import torch
    from ln3diff_tpu_torch.models.eg3d import TriPlaneGeneratorConfig
    from ln3diff_tpu_torch.models.vae_shapenet import FFHQVAE, FFHQVAEConfig
    from ln3diff_tpu_torch.models.vit import vit_registry
    from ln3diff_tpu_torch.render.renderer import RenderOptions
    from ln3diff_tpu_torch.training.eg3d_warmup import (EG3DWarmupTrainer,
                                                        WarmupConfig)
    cfg = FFHQVAEConfig(
        encoder_vit=vit_registry('dinov2-s/14', img_size=56, embed_dim=32,
                                 depth=2, num_heads=2),
        token_size=4, decoder_embed_dim=32, decoder_fusion_depth=2,
        decoder_num_heads=2, channel_multiplier=2, plane_channels=8,
        triplane_resolution=32, decoder_output_dim=8, dtype=torch.float32)
    with torch.device(device):
        model = FFHQVAE(cfg, encoder=True)
    return EG3DWarmupTrainer(
        cfg, TriPlaneGeneratorConfig(z_dim=16, w_dim=512,
                                     plane_resolution=32, plane_channels=8,
                                     decoder_output_dim=8),
        WarmupConfig(lr=2e-3, ema_rate=0.5, batch_size=2,
                     render_resolution=16, num_shape_points=256,
                     log_interval=10**9),
        render_opts=RenderOptions(depth_resolution=8,
                                  depth_resolution_importance=8,
                                  ray_start=2.25, ray_end=3.3, box_warp=1.0,
                                  white_back=False),
        seed=seed, model=model, device=device)


def small_eg3d_warmup_reference():
    """One small warm-up step (``_small_warmup``) on the card and on the
    CPU from the same weights (the student's off JAX's zero inits: the
    adaLN-free ViT, ``sr_ws`` drawn), cameras and draws: the loss, each
    term, every grad and the AdamW step (``TOL_EG3D_TRAIN``)."""
    import torch
    from ln3diff_tpu_torch.render.renderer import draw_uniforms
    from ln3diff_tpu_torch.training.eg3d_warmup import WarmupDraws
    cpu = _small_warmup('cpu')
    with torch.no_grad():
        cpu.model.sr_ws.copy_(torch.randn(
            512, generator=torch.Generator().manual_seed(8)) * 0.3)
    card = _small_warmup('cuda')
    card.model.load_state_dict(cpu.model.state_dict())
    card.teacher.load_state_dict(cpu.teacher.state_dict())
    cam = torch.from_numpy(cpu._sample_cameras(2))
    g = torch.Generator().manual_seed(4)
    draws = WarmupDraws(torch.randn((2, 16), generator=g),
                        torch.rand((2, 256, 3), generator=g) - 0.5,
                        torch.randn((2, 4, 4, 4, 3), generator=g),
                        draw_uniforms(2, 16**2, cpu.opts, g, 'cpu'))
    out = {}
    for name, tr in (('cpu', cpu), ('cuda', card)):
        d, c = _to(draws, tr.device), cam.to(tr.device)
        loss, terms = tr.loss_fn(None, None, {'c': c}, d)
        loss.backward()
        out[name] = dict(loss=loss.item(), grads=_grads(tr.model),
                         terms={k: float(v) for k, v in terms.items()})
        tr.train_step(c, draws=d)
        out[name]['params'] = {k: p.detach().cpu() for k, p in
                               tr.state.params.items()}
    lc, lg = out['cpu']['loss'], out['cuda']['loss']
    check(abs(lg - lc) <= TOL_EG3D_TRAIN * abs(lc),
          f'warm-up: loss {lg} vs CPU {lc}')
    check(sorted(out['cpu']['terms']) == ['depth', 'img', 'plane', 'shape',
                                          'ws'], 'warm-up terms')
    for k, v in out['cpu']['terms'].items():
        w = out['cuda']['terms'][k]
        check(abs(w - v) <= TOL_EG3D_TRAIN * abs(v),
              f'warm-up: {k} {w} vs CPU {v}')
    worst = _worst_grad(out['cuda']['grads'], out['cpu']['grads'],
                        TOL_EG3D_TRAIN, 'warm-up')
    step = _check_step(out['cuda']['params'], out['cpu']['params'],
                       out['cpu']['grads'], TOL_EG3D_TRAIN, 2e-3, 'warm-up')
    return dict(loss_cpu=lc, loss_cuda=lg, loss_rel_err=abs(lg - lc) / lc,
                terms_cuda=out['cuda']['terms'],
                grad_err_in_units_of_tol=worst, max_step_err_resolved=step,
                tensors=len(out['cpu']['grads']))


def eg3d_warmup(steps=5, warmup=2):
    """The EG3D warm-up at full width through its entry point
    (``python -m ln3diff_tpu_torch.training.eg3d_warmup``'s ``main``):
    ``vae_preset('ffhq')`` (bf16 over f32 parameters) against the default
    ``TriPlaneGenerator`` teacher (z 512, w 512, 256² planes of 3 × 32
    channels), ``WarmupConfig`` defaults (batch 4, 64² renders, 4,096
    shape points, ψ 0.7) under ``RENDER_PRESETS['ffhq']`` (48+48 samples),
    random weights from seed 0, ``warmup + steps`` steps and the final
    checkpoint in a temporary directory.  Each step is timed (host clock,
    synchronised; the mean over the steps after ``warmup``); the memory
    resident when the first step starts and the peak above it; the
    per-term losses, finite; the checkpoint restored into a second trainer
    (another seed), every tensor bit for bit; then one profiled step."""
    import torch
    from ln3diff_tpu_torch.config import build_vae
    from ln3diff_tpu_torch.training import eg3d_warmup as ew
    from ln3diff_tpu_torch.training.checkpoint import CheckpointManager
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    rec = dict(secs=[], metrics=[])
    plain_step = ew.EG3DWarmupTrainer.train_step

    def timed_step(self, camera25, draws=None):
        if not rec['metrics']:
            torch.cuda.synchronize()
            rec['resident'] = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = plain_step(self, camera25, draws)
        torch.cuda.synchronize()
        rec['secs'].append(time.perf_counter() - t0)
        rec['metrics'].append({k: float(v) for k, v in m.items()})
        return m

    n = warmup + steps
    with tempfile.TemporaryDirectory() as d:
        ew.EG3DWarmupTrainer.train_step = timed_step
        try:
            t0 = time.perf_counter()
            tr = ew.main(['--outdir', d, '--total_steps', str(n),
                          '--save_interval', str(n),
                          '--log_interval', str(10**6)])
            main_s = time.perf_counter() - t0
        finally:
            ew.EG3DWarmupTrainer.train_step = plain_step
        peak = torch.cuda.max_memory_allocated() - base - rec['resident']
        mgr = CheckpointManager(os.path.join(d, 'ckpt'))
        check(mgr.all_steps() == [n], f'checkpoints {mgr.all_steps()}')
        nbytes = os.path.getsize(os.path.join(d, 'ckpt', str(n),
                                              'state.pt'))
        with torch.device('cuda'):
            model = build_vae(tr.model_cfg, encoder=True)
        twin = ew.EG3DWarmupTrainer(tr.model_cfg, warm_cfg=tr.cfg,
                                    render_opts=tr.opts, seed=1, model=model,
                                    device='cuda')
        t0 = time.perf_counter()
        mgr.restore(twin.state)
        restore_s = time.perf_counter() - t0
    a, b = tr.state, twin.state
    tensors = 0
    for x, y in [(a.params, b.params), (a.ema_params['ema'],
                                       b.ema_params['ema'])] + [
            (a.opt_state[m], b.opt_state[m]) for m in ('mu', 'nu')]:
        for k, v in x.items():
            check(torch.equal(v, y[k]), f'warm-up checkpoint: {k} differs')
            tensors += 1
    check(b.step == a.step == n and b.opt_state['count'] == n,
          'warm-up checkpoint: step or count differs')
    del twin, b, model
    torch.cuda.empty_cache()
    profile = _train_step_profile(tr, torch.as_tensor(
        tr._sample_cameras(tr.cfg.batch_size), device='cuda'))
    terms = rec['metrics'][-1]
    check(len(rec['secs']) == n, f'{len(rec["secs"])} steps timed')
    check(all(math.isfinite(v) for m in rec['metrics'] for v in m.values()),
          f'warm-up metrics {rec["metrics"]}')
    check(sorted(terms) == ['depth', 'grad_norm', 'img', 'loss', 'plane',
                            'shape', 'ws'], f'warm-up terms {sorted(terms)}')
    timed = rec['secs'][warmup:]
    res = dict(
        s_per_step=sum(timed) / len(timed), s_per_step_runs=timed,
        warmup_step_s=rec['secs'][:warmup], main_seconds=main_s,
        losses=[m['loss'] for m in rec['metrics']], last_metrics=terms,
        teacher_params=sum(p.numel() for p in tr.teacher.parameters()),
        student_params=sum(p.numel() for p in tr.model.parameters()),
        resident_gib=round(rec['resident'] / 2**30, 3),
        peak_above_resident_gib=round(peak / 2**30, 3),
        checkpoint=dict(step=n, tensors=tensors, bytes=nbytes,
                        restore_s=restore_s),
        profile=profile)
    del tr
    # the trainer holds a reference cycle (its step closes over its loss)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _small_lgm_vae(device):
    """A small VAE with the ``'lgm'`` encoder: two views of 32² × 10, down
    channels (32, 64) with the attention at the second level, f32."""
    import torch
    from ln3diff_tpu_torch.models.dit import DiT2Config
    from ln3diff_tpu_torch.models.vae import TriplaneVAE, TriplaneVAEConfig
    cfg = TriplaneVAEConfig(
        encoder_ch=8, encoder_ch_mult=(1, 2), img_resolution=32,
        num_views=2, latent_size=16, encoder_type='lgm',
        lgm_down_channels=(32, 64), lgm_down_attention=(False, True),
        dit2=DiT2Config(tokens_per_plane=64, hidden_size=32, depth=2,
                        num_heads=2, dtype=torch.float32),
        conv_sr_ch=8, conv_sr_ch_mult=(1, 2), dtype=torch.float32)
    with torch.device(device):
        return TriplaneVAE(cfg, encoder=True)


def lgm_encode():
    """The ``'lgm'`` encoder at full width: ``vae_preset('objaverse')``
    with ``encoder_type='lgm'`` (down channels 64-128-256-512, joint-view
    attention at 64² and 32² over 4 × 64² = 16,384 and 4,096 tokens, 16
    heads, in query chunks) under bf16 autocast, 4 views of 256² × 10,
    batch 1, no grad: ms per encode (CUDA events) and peak memory; then a
    small one card vs CPU (``TOL_PIPE``)."""
    import torch
    from ln3diff_tpu_torch.config import vae_preset
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.vae import TriplaneVAE
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(vae_preset('objaverse'), encoder_type='lgm')
    with torch.device('cuda'):
        vae = TriplaneVAE(cfg, encoder=True)
    random_init_(vae, torch.Generator(device='cuda').manual_seed(0))
    x = torch.randn((4, 256, 256, 10), device='cuda',
                    generator=torch.Generator(device='cuda').manual_seed(1))
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()

    def encode():
        with torch.no_grad(), torch.autocast('cuda', dtype=cfg.dtype):
            return vae.encode(x)

    moments = encode()
    with torch.no_grad(), torch.autocast('cuda', dtype=cfg.dtype):
        h = vae.encoder(x)
    check(tuple(h.shape) == (1, 32, 32, 24), f'lgm encoder {tuple(h.shape)}')
    check(tuple(moments.shape) == (1, 32, 32, 8, 3),
          f'lgm moments {tuple(moments.shape)}')
    check(bool(torch.isfinite(moments).all()), 'lgm moments not finite')
    ms = cuda_time_ms(encode, warmup=1, iters=5)
    peak = torch.cuda.max_memory_allocated() - base - resident
    enc_params = sum(p.numel() for p in vae.encoder.parameters())
    del vae, x, moments, h
    torch.cuda.empty_cache()
    # a small one, card vs CPU
    cpu = _small_lgm_vae('cpu')
    random_init_(cpu, torch.Generator().manual_seed(2))
    card = _small_lgm_vae('cuda')
    card.load_state_dict(cpu.state_dict())
    xs = torch.randn((4, 32, 32, 10), generator=torch.Generator()
                     .manual_seed(3))
    with torch.no_grad():
        want = cpu.encode(xs)
        got = card.encode(xs.cuda()).cpu()
    err = float(((got - want).abs() / want.abs().clamp(min=1)).max())
    check(err <= TOL_PIPE, f'small lgm encode: card vs CPU {err}')
    return dict(ms=ms, peak_above_resident_gib=round(peak / 2**30, 3),
                resident_gib=round(resident / 2**30, 3),
                encoder_params=enc_params,
                moments_shape=[1, 32, 32, 8, 3],
                small_card_vs_cpu=err,
                moments_abs_max=float(want.abs().max()))


def stylegan3():
    """``GeneratorSG3`` at its defaults (z 512, w 512, 256² × 3, 14
    layers, channel base 32768, f32) at batch 4, random weights from seed
    0, ψ 0.7: ms per forward (CUDA events) and peak memory; then a small
    one (32², 6 layers, channel base 1024 and max 32) card vs CPU
    (``TOL_PIPE``)."""
    import torch
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.models.stylegan3 import GeneratorSG3
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    with torch.device('cuda'):
        g = GeneratorSG3()
    random_init_(g, torch.Generator(device='cuda').manual_seed(0))
    z = torch.randn((4, 512), device='cuda',
                    generator=torch.Generator(device='cuda').manual_seed(1))
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()

    def forward():
        with torch.no_grad():
            return g(z, truncation_psi=0.7)

    img = forward()
    check(tuple(img.shape) == (4, 256, 256, 3), f'sg3 {tuple(img.shape)}')
    check(bool(torch.isfinite(img).all()), 'sg3 image not finite')
    ms = cuda_time_ms(forward, warmup=1, iters=5)
    peak = torch.cuda.max_memory_allocated() - base - resident
    n_params = sum(p.numel() for p in g.parameters())
    img_range = [float(img.min()), float(img.max())]
    del g, z, img
    torch.cuda.empty_cache()
    kw = dict(z_dim=32, w_dim=32, img_resolution=32, num_layers=6,
              channel_base=1024, channel_max=32)
    cpu = GeneratorSG3(**kw)
    random_init_(cpu, torch.Generator().manual_seed(2))
    with torch.device('cuda'):
        card = GeneratorSG3(**kw)
    card.load_state_dict(cpu.state_dict())
    zs = torch.randn((2, 32), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = cpu(zs, truncation_psi=0.7)
        got = card(zs.cuda(), truncation_psi=0.7).cpu()
    err = float(((got - want).abs() / want.abs().clamp(min=1)).max())
    check(err <= TOL_PIPE, f'small sg3: card vs CPU {err}')
    return dict(ms=ms, batch=4, params=n_params, image_range=img_range,
                resident_gib=round(resident / 2**30, 3),
                peak_above_resident_gib=round(peak / 2**30, 3),
                small_card_vs_cpu=err)


# -- the entry layer: reference checkpoints, the sample CLI, legacy pickles --

def _reference_sd_module():
    """``tests/_torch_reference_sd.py``: the reference-named state dicts
    (the inverse of each converter with the bridge) and the persistence
    pickle writer, the same module the CPU tests use."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, 'tests'))
    import _torch_reference_sd
    return _torch_reference_sd


class HostPeak:
    """The peak resident host memory of the process over a phase: a
    thread reads ``/proc/self/statm`` every 10 ms from ``start()`` to
    ``stop()`` (the kernel's own high-water mark cannot be reset on every
    machine).  Without ``/proc`` it reports the process's lifetime peak
    (``ru_maxrss``) and says so."""

    def __init__(self):
        import threading
        self.scope = 'phase' if os.path.exists('/proc/self/statm') \
            else 'process'
        self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _rss(self):
        if self.scope == 'phase':
            with open('/proc/self/statm') as f:
                return int(f.read().split()[1]) * os.sysconf('SC_PAGE_SIZE')
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024

    def _poll(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self._rss())

    def stop(self):
        """Stop sampling → the phase's memory fields (device peak since the
        phase's ``reset_peak_memory_stats``)."""
        import torch
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())
        return dict(peak_device_gib=round(torch.cuda.max_memory_allocated()
                                          / 2**30, 3),
                    peak_host_gib=round(self.peak / 2**30, 3),
                    peak_host_scope=self.scope)


def write_safetensors(sd, path):
    """A few lines of ``.safetensors`` writer: u64 header length, the JSON
    header (``dtype``, ``shape``, ``data_offsets``), the raw buffers."""
    import struct
    import torch
    names = {torch.float32: 'F32', torch.float16: 'F16',
             torch.bfloat16: 'BF16'}
    header, offset = {}, 0
    for k, t in sd.items():
        n = t.numel() * t.element_size()
        header[k] = dict(dtype=names[t.dtype],
                         shape=list(t.shape), data_offsets=[offset,
                                                            offset + n])
        offset += n
    blob = json.dumps(header).encode()
    blob += b' ' * (-len(blob) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(blob)) + blob)
        for t in sd.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy().data)


def _same_bytes(a, b, block=1 << 26):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
        while True:
            x, y = fa.read(block), fb.read(block)
            if x != y:
                return False
            if not x:
                return True


def _run_cli(main, argv):
    """An entry's ``main(argv)`` in process, its standard output kept
    (and echoed to the run's standard error)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    sys.stderr.write(buf.getvalue())
    return out, buf.getvalue()


def reference_checkpoint(workdir):
    """The released ``objaverse/t23d-dit`` joint checkpoint, written at
    full width from random weights and converted by the port's CLI.  The
    DiT-L/2 (``denoiser_preset('t23d-dit-l2')``) and the Objaverse VAE
    with its encoder (``vae_preset('objaverse')``) draw their weights on
    the card (``random_init_``, seeds 11 and 12); ``_torch_reference_sd``
    renames them to the reference's ``ddpm_model.*`` / ``rec_model.*``
    keys (with the DiT's top-level ``mixing_logit``), about 1.03 B f32
    values.  The dict goes to ``model_joint_denoise_rec_model.pt``
    (``torch.save``) and ``.safetensors`` (``write_safetensors``); the
    convert CLI (``python -m ln3diff_tpu_torch.scripts.convert_checkpoint
    --kind joint-objaverse --verify``) runs in process on each, with 0
    mismatches against the port's modules, and the two output directories
    must hold the same bytes.  Each step is timed.  Returns the phase's
    fields and what ``sample_entry`` reads."""
    import shutil
    import torch
    from ln3diff_tpu_torch.config import denoiser_preset, vae_preset
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent
    from ln3diff_tpu_torch.models.vae import TriplaneVAE
    from ln3diff_tpu_torch.scripts import convert_checkpoint as cc
    R = _reference_sd_module()
    host = HostPeak()
    torch.cuda.reset_peak_memory_stats()
    secs = {}
    t0 = time.perf_counter()
    with torch.device('cuda'):
        den = DiT_TriLatent(denoiser_preset('t23d-dit-l2'))
        vae = TriplaneVAE(vae_preset('objaverse'), encoder=True)
    den_sd = R.port_state_dict(den, 11)
    vae_sd = R.port_state_dict(vae, 12)
    del den, vae
    torch.cuda.empty_cache()
    ml = torch.full((1, 12, 1, 1), -6.0)
    ref = R.joint_objaverse_reference(den_sd, vae_sd, mixing_logit=ml)
    secs['draw'] = time.perf_counter() - t0
    params = dict(denoiser=sum(t.numel() for t in den_sd.values()),
                  vae=sum(t.numel() for t in vae_sd.values()))
    params['total'] = params['denoiser'] + params['vae']
    check(1.0e9 < params['total'] < 1.1e9, f'joint params {params}')
    check(all(t.dtype == torch.float32 for t in ref.values()),
          'the reference dict is not all f32')
    outs, verify, sizes = {}, {}, {}
    for ext, write in (('safetensors', write_safetensors), ('pt', torch.save)):
        src = os.path.join(workdir, f'model_joint_denoise_rec_model.{ext}')
        t0 = time.perf_counter()
        write(ref, src)
        secs[f'write_{ext}'] = time.perf_counter() - t0
        sizes[os.path.basename(src)] = os.path.getsize(src)
        outs[ext] = os.path.join(workdir, f'converted_{ext}')
        t0 = time.perf_counter()
        written, log = _run_cli(cc.main, [
            '--src', src, '--kind', 'joint-objaverse', '--outdir',
            outs[ext], '--verify'])
        secs[f'convert_{ext}'] = time.perf_counter() - t0
        os.remove(src)
        lines = [ln.strip() for ln in log.splitlines() if 'leaves' in ln]
        check(len(lines) == 2 and all(ln.endswith(' 0 mismatches')
                                      for ln in lines),
              f'--verify of the {ext} conversion: {lines}')
        files = sorted(os.listdir(outs[ext]))
        check(sorted(written) == ['denoiser', 'mixing_logit', 'vae'] and
              files == ['denoiser.npz', 'mixing_logit.npy', 'vae.npz'],
              f'converted files {files}')
        verify[ext] = lines
    t0 = time.perf_counter()
    for f in files:
        check(_same_bytes(os.path.join(outs['pt'], f),
                          os.path.join(outs['safetensors'], f)),
              f'{f} differs between the .pt and .safetensors conversions')
    secs['compare'] = time.perf_counter() - t0
    shutil.rmtree(outs['safetensors'])
    sizes.update({f: os.path.getsize(os.path.join(outs['pt'], f))
                  for f in files})
    res = dict(seconds_by_step={k: round(v, 3) for k, v in secs.items()},
               params=params, tensors=len(ref), bytes=sizes,
               verify=verify['pt'], outputs_equal=True, **host.stop())
    # a sample of the reference tensors, by the port's names, for
    # sample_entry's weight check
    def pick(to_reference, prefix, names):
        return {k: ref[next(iter(to_reference({k: None}, prefix)))]
                for k in names}
    sample = dict(
        denoiser=pick(R.dit_reference, 'ddpm_model.', (
            'blocks.0.attn.qkv.weight', 'blocks.23.mlp.fc2.weight',
            'final_layer.linear.weight', 'x_embedder.proj.weight')),
        vae=pick(R.vae_objaverse_reference, 'rec_model.', (
            'dit2.blocks.0.within.attn.qkv.weight',
            'conv_sr.conv_out.weight', 'osg_decoder.EqualDense_0.weight',
            'ldm_upsample.weight')))
    del ref, den_sd, vae_sd
    gc.collect()
    return res, dict(dir=outs['pt'], sample=sample)


def _toy_sample_cfgs(torch):
    """A small text→3D model for the card-vs-CPU check of the sample
    entry: a depth-2 DiT of width 64, a VAE with the release's channel
    multipliers at 32² views and 8² latents, 32 plane channels (kernel
    1's), a one-layer CLIP text tower; f32."""
    from ln3diff_tpu_torch.conditioning.clip import CLIPTextConfig
    from ln3diff_tpu_torch.models.dit import DiT2Config, DiTConfig
    from ln3diff_tpu_torch.models.vae import TriplaneVAEConfig
    return (DiTConfig(input_size=8, patch_size=2, in_channels=4,
                      hidden_size=64, depth=2, num_heads=2, context_dim=64,
                      dtype=torch.float32),
            TriplaneVAEConfig(
                encoder_ch=8, encoder_ch_mult=(1, 2, 4, 4),
                img_resolution=32, num_views=4, ldm_z_channels=4,
                latent_size=8, patch_size=2, conv_sr_ch=8,
                conv_sr_ch_mult=(1, 2, 2, 4), conv_sr_res_blocks=1,
                plane_channels=32, decoder_output_dim=32,
                dit2=DiT2Config(tokens_per_plane=16, hidden_size=32,
                                depth=2, num_heads=2, dtype=torch.float32),
                dtype=torch.float32),
            CLIPTextConfig(hidden_size=64, num_layers=1, num_heads=2,
                           intermediate_size=128))


def _small_sample_reference(workdir):
    """The sample entry on a small converted model, on the card and on the
    CPU: a toy joint checkpoint through the convert CLI, then
    ``main([...])`` with ``model_configs`` set to the toy configs and one
    start latent for both devices; DDIM 8 at CFG 6.5, 8 frames of 32²,
    a 32³ mesh grid; the random text tower drawn on the CPU for both.
    The frames and latents within ``TOL_PIPE`` of scale (the card's render
    through kernel 1, the CPU's plain)."""
    import torch
    from ln3diff_tpu_torch.models import layers
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent
    from ln3diff_tpu_torch.models.vae import TriplaneVAE
    from ln3diff_tpu_torch.scripts import convert_checkpoint as cc
    from ln3diff_tpu_torch.scripts import vit_triplane_diffusion_sample as vs
    R = _reference_sd_module()
    den_cfg, vae_cfg, text_cfg = _toy_sample_cfgs(torch)
    den = R.port_state_dict(DiT_TriLatent(den_cfg), 21)
    vae = R.port_state_dict(TriplaneVAE(vae_cfg, encoder=True), 22)
    src = os.path.join(workdir, 'toy_joint.pt')
    torch.save(R.joint_objaverse_reference(den, vae), src)
    out = os.path.join(workdir, 'toy_converted')

    def toy_module(kind, which, args):
        with torch.device('meta'):
            return (DiT_TriLatent(den_cfg) if which == 'denoiser'
                    else TriplaneVAE(vae_cfg, encoder=True))

    x0 = torch.randn((1, 8, 8, 12), generator=torch.Generator()
                     .manual_seed(23))
    plain_init = layers.random_init_

    def cpu_init(module, generator=None):
        twin = copy.deepcopy(module).cpu()
        plain_init(twin, torch.Generator().manual_seed(24))
        module.load_state_dict(twin.state_dict())
        return module

    saved = (cc.target_module, vs.model_configs, vs.start_noise)
    cc.target_module = toy_module
    vs.model_configs = lambda args: (den_cfg, vae_cfg, text_cfg)
    vs.start_noise = lambda shape, gen, device: x0.to(device)
    layers.random_init_ = cpu_init
    try:
        _run_cli(cc.main, ['--src', src, '--kind', 'joint-objaverse',
                           '--outdir', out, '--verify', '--dit_depth', '2',
                           '--dit2_depth', '2'])
        runs = {}
        for device in ('cuda', 'cpu'):
            runs[device], _ = _run_cli(vs.main, [
                '--prompts', 'a red wooden chair', '--vae', 'objaverse',
                '--outdir', os.path.join(workdir, f'toy_{device}'),
                '--denoiser_ckpt', os.path.join(out, 'denoiser.npz'),
                '--vae_ckpt', os.path.join(out, 'vae.npz'),
                '--num_steps', '8', '--num_frames', '8',
                '--render_resolution', '32', '--mesh_grid', '32',
                '--video_format', 'png', '--device', device])
    finally:
        cc.target_module, vs.model_configs, vs.start_noise = saved
        layers.random_init_ = plain_init
    errs = {}
    for key in ('latents', 'video'):
        a = torch.as_tensor(runs['cuda']['outputs'][0][key]).float().cpu()
        b = torch.as_tensor(runs['cpu']['outputs'][0][key]).float()
        scale = max(1.0, float(b.abs().max()))
        errs[key] = float((a - b).abs().max()) / scale
        check(errs[key] <= TOL_PIPE, f'small sample entry: {key} card vs '
              f'CPU {errs[key]} of scale, tolerance {TOL_PIPE}')
    return dict(rel_err=errs, tolerance=TOL_PIPE)


def sample_entry(ckpt, workdir):
    """The sample CLI (``python -m
    ln3diff_tpu_torch.scripts.vit_triplane_diffusion_sample``) in process
    as a user runs the release: ``--preset objaverse/t23d-dit`` (DDIM 250,
    CFG 6.5, divider 0.96806, the DiT-L/2 at exact GELU stored in bf16,
    the Objaverse VAE), ``--denoiser_ckpt`` / ``--vae_ckpt`` from
    ``reference_checkpoint``'s conversion, one prompt, the script's
    default 24-frame orbit of 128² renders (64+64 samples, f32 planes,
    kernel 1) and 192³ mesh grid, ``--device cuda``.  Kernel 1's counter
    must read 48 render launches (24 frames × coarse and importance
    passes) + 27 σ chunks (+ the vertex colours' launches when the mesh
    has vertices); kernels 2–4 read 0.  A sample of loaded weights must
    equal the reference tensors cast to the stored dtype, bit for bit;
    the frames finite and in [-1, 1]; the OBJ must parse; the ``.avi``
    must hold 24 frames when Pillow imports (the line ``pillow: ...``
    says whether it does).  Then ``_small_sample_reference``."""
    import torch
    from ln3diff_tpu_torch.scripts import vit_triplane_diffusion_sample as vs
    try:
        import PIL
        pillow = f'pillow {PIL.__version__}'
    except ImportError as e:
        pillow = f'no pillow ({e})'
    print(f'pillow: {pillow}', flush=True)
    fmt = 'avi' if pillow.startswith('pillow ') else 'png'
    host = HostPeak()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    outdir = os.path.join(workdir, 'samples')
    prompt = 'a red wooden chair with four legs'
    zero_kernel_launches()
    t0 = time.perf_counter()
    res, log = _run_cli(vs.main, [
        '--preset', 'objaverse/t23d-dit', '--prompts', prompt,
        '--denoiser_ckpt', os.path.join(ckpt['dir'], 'denoiser.npz'),
        '--vae_ckpt', os.path.join(ckpt['dir'], 'vae.npz'),
        '--outdir', outdir, '--device', 'cuda', '--video_format', fmt])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = kernel_launches()
    out = res['outputs'][0]
    nv, nf = obj_counts(out['mesh_path'])
    verts, faces = out['mesh']
    check((nv, nf) == (len(verts), len(faces)),
          f'OBJ parses to {nv} / {nf}, the call returned {len(verts)} / '
          f'{len(faces)}')
    vertex_launches = counts['fused_osg'] - 75
    check(counts['fused_osg'] == 75 if nv == 0 else vertex_launches > 0,
          f'kernel 1 launched {counts["fused_osg"]} times, expected 48 + 27')
    check(counts['fused_osg_bwd'] == counts['fused_attention']
          == counts['fused_qkv_attention'] == 0,
          f'sample entry: other kernels launched {counts}')
    video = torch.as_tensor(out['video'])
    check(tuple(video.shape) == (24, 128, 128, 3),
          f'video shape {tuple(video.shape)}')
    check(bool(torch.isfinite(video).all()), 'frames not finite')
    vmin, vmax = float(video.min()), float(video.max())
    check(-1.0 <= vmin and vmax <= 1.0, f'frames in [{vmin}, {vmax}]')
    check(bool(torch.isfinite(out['latents']).all()), 'latents not finite')
    if fmt == 'avi':
        with open(out['video_path'], 'rb') as f:
            data = f.read()
        i = data.rindex(b'idx1')
        n = int.from_bytes(data[i + 4:i + 8], 'little') // 16
        frames = sum(data[i + 8 + 16 * e:i + 12 + 16 * e] == b'00dc'
                     for e in range(n))
        check(frames == 24, f'the .avi holds {frames} frames')
    mods = res['modules']
    checked = 0
    for part, picks in ckpt['sample'].items():
        own = mods[part].state_dict()
        for k, ref_t in picks.items():
            got = own[k].detach().cpu()
            check(torch.equal(got, ref_t.to(got.dtype)),
                  f'loaded {part}.{k} differs from the reference tensor '
                  f'cast to {got.dtype}')
            checked += 1
    check(str(mods['denoiser'].t_embedder.fc1.weight.dtype)
          == 'torch.bfloat16', 'the denoiser is not stored in bf16')
    wall, load_s = out['sample_wall_s'], res['load_seconds']
    mem = host.stop()
    del res, mods, out, video
    gc.collect()
    torch.cuda.empty_cache()
    small = _small_sample_reference(workdir)
    return dict(
        main_seconds=round(main_s, 3), sample_wall_s=round(wall, 3),
        load_seconds={k: round(v, 3) for k, v in load_s.items()},
        fused_osg_launches=dict(total=counts['fused_osg'], render=48,
                                sigma_query=27,
                                vertex_colors=vertex_launches),
        kernel_launches=counts, frames_range=[vmin, vmax],
        mesh=dict(vertices=nv, faces=nf), video_format=fmt, pillow=pillow,
        weights_checked=checked, small_reference=small, **mem)


EG3D_G_EMA_PARAMS = 30_763_230


def eg3d_teacher_pickle(workdir):
    """A persistence-format pickle (``legacy.py``'s ``{'G', 'D', 'G_ema',
    'training_set_kwargs'}``) of the default-size EG3D ``G_ema``
    (``TriPlaneGeneratorConfig()``, 30,763,230 parameters; random draws,
    seed 13, and a drawn ``w_avg``) under the reference's names, with a
    ``module_src`` that would create a flag file if it were executed;
    ``legacy_pkl_to_npz`` (``python -m
    ln3diff_tpu_torch.scripts.legacy_pkl_to_npz``) in process; then 2
    steps of ``ln3diff_tpu_torch.training.eg3d_warmup.main([...,
    '--teacher_ckpt', npz])``.  The teacher's parameters and ``w_avg``
    must equal the pickle's, the losses be finite and the flag absent."""
    import torch
    from ln3diff_tpu_torch.models.eg3d import (TriPlaneGenerator,
                                               TriPlaneGeneratorConfig)
    from ln3diff_tpu_torch.scripts import legacy_pkl_to_npz as lp
    from ln3diff_tpu_torch.training import eg3d_warmup as ew
    R = _reference_sd_module()
    host = HostPeak()
    torch.cuda.reset_peak_memory_stats()
    secs = {}
    t0 = time.perf_counter()
    with torch.device('cuda'):
        gen = TriPlaneGenerator(TriPlaneGeneratorConfig())
    n_params = sum(p.numel() for p in gen.parameters())
    check(n_params == EG3D_G_EMA_PARAMS, f'G_ema has {n_params} params')
    sd = R.port_state_dict(gen, 13)
    del gen
    sd['mapping.w_avg'] = torch.randn(sd['mapping.w_avg'].shape,
                                      generator=torch.Generator()
                                      .manual_seed(14))
    flag = os.path.join(workdir, 'PICKLED_SOURCE_RAN')
    pkl = os.path.join(workdir, 'network-snapshot.pkl')
    R.write_persistence_pickle(pkl, {
        'G_ema': R.eg3d_reference(sd, prefix=''), 'G': None, 'D': None},
        f'open({flag!r}, "w").write("executed")\n')
    secs['write_pickle'] = time.perf_counter() - t0
    npz = os.path.join(workdir, 'network-snapshot.npz')
    t0 = time.perf_counter()
    flat, _ = _run_cli(lp.main, [pkl, npz, '--keys', 'G_ema'])
    secs['legacy_pkl_to_npz'] = time.perf_counter() - t0
    check(len(flat) == len(sd), f'{len(flat)} arrays from the pickle, '
          f'{len(sd)} in the generator')
    check(not os.path.exists(flag), 'the pickled source was executed')
    metrics = []
    plain_step = ew.EG3DWarmupTrainer.train_step

    def recorded(self, camera25, draws=None):
        m = plain_step(self, camera25, draws)
        metrics.append({k: float(v) for k, v in m.items()})
        return m

    ew.EG3DWarmupTrainer.train_step = recorded
    try:
        t0 = time.perf_counter()
        tr = ew.main(['--outdir', os.path.join(workdir, 'warmup'),
                      '--teacher_ckpt', npz, '--total_steps', '2',
                      '--save_interval', '2', '--log_interval', str(10**6)])
        secs['warmup_main'] = time.perf_counter() - t0
    finally:
        ew.EG3DWarmupTrainer.train_step = plain_step
    got = tr.teacher.state_dict()
    for k, v in sd.items():
        check(torch.equal(got[k].cpu(), v), f'teacher {k} differs from the '
              f'pickle')
    check(len(metrics) == 2 and all(math.isfinite(v) for m in metrics
                                    for v in m.values()),
          f'warm-up metrics {metrics}')
    res = dict(seconds_by_step={k: round(v, 3) for k, v in secs.items()},
               params=n_params, arrays=len(flat),
               pickle_bytes=os.path.getsize(pkl),
               teacher_tensors_equal=len(sd),
               w_avg_equal=True, losses=[m['loss'] for m in metrics],
               **host.stop())
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return res


# -- the parallel layer and the training entry points ------------------------

def init_nccl(workdir):
    """A one-rank NCCL process group over a file store: this script needs
    one card, so the parallel layer runs at world size 1 here (its
    multi-rank semantics are held against JAX in the CPU tests, and on
    four cards by ``scripts/parallel_card_check.py``)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', store=dist.FileStore(
        os.path.join(workdir, 'nccl_store'), 1), rank=0, world_size=1)


def _record_first_grads(state, into: dict):
    """Keep a copy of the grads of ``state``'s first update in ``into``."""
    apply = state.apply_gradients

    def record(grads, g_norm=None):
        if not into:
            into.update({k: g.detach().clone() for k, g in grads.items()})
        return apply(grads, g_norm)

    state.apply_gradients = record


def _flatten_views(raw):
    """A streamed batch's instances × views as rows, the views' fields of
    ``tests/test_integration_wds.py`` (the encoder's and the supervised
    input views')."""
    out = {}
    for k in ('img_to_encoder', 'img', 'depth', 'depth_mask', 'c', 'bbox'):
        v = raw[k]
        out[k] = v.reshape((-1,) + v.shape[2:])
    return out


def data_vae_train(workdir, steps=3, instances=8, views=8, reso=256):
    """The data layer feeding the full-width VAE step: ``instances``
    synthetic instances of ``views`` views at ``reso``² written into tar
    shards by the port's ``wds_create`` CLI; ``iter_shards_native`` (the
    g++-built reader) against ``iter_shard`` on those shards, every sample
    equal, each reader's batches/s (2 instances collated a batch) over one
    pass; ``load_wds_data`` with ``PostProcess(reso_encoder=256,
    reso_render=128, num_views_input=4, num_views_sup=2)`` (its ms per
    instance) into ``steps`` steps of ``VAETrainer`` with the kernel pair
    (``_train_cfgs(small=False)``, ``use_fused_osg=True``) on the views
    flattened as in ``tests/test_integration_wds.py``.  Checked: finite
    losses, grad_norm > 0, the trained parameters changed, and 8 launches
    each of kernels 1 and 2 per step (counters set to 0 just before each
    step, read just after)."""
    import numpy as np
    import torch
    from ln3diff_tpu_torch.data.objaverse import PostProcess
    from ln3diff_tpu_torch.data.wds import (collate, iter_shard,
                                            iter_shards_native,
                                            load_wds_data)
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.scripts import wds_create
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainer

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shard_dir = os.path.join(workdir, 'shards')
    paths = wds_create.main([
        '--out', os.path.join(shard_dir, 'objv-%06d.tar'),
        '--num_instances', str(instances), '--num_views', str(views),
        '--resolution', str(reso), '--maxcount', str(instances // 2)])
    write_s = time.perf_counter() - t0
    shard_mb = sum(os.path.getsize(p) for p in paths) / 2**20

    def read_pass(samples):
        """Batches of 2 instances over one pass: (samples, batches/s)."""
        t = time.perf_counter()
        got, batch, n = [], [], 0
        for smp in samples:
            got.append(smp)
            batch.append(smp)
            if len(batch) == 2:
                collate(batch)
                batch, n = [], n + 1
        return got, n / (time.perf_counter() - t)

    tar_samples, tar_bps = read_pass(s for p in paths
                                     for s in iter_shard(p))
    nat_samples, nat_bps = read_pass(iter_shards_native(paths))
    check(len(tar_samples) == len(nat_samples) == instances,
          f'samples: tarfile {len(tar_samples)}, native '
          f'{len(nat_samples)}, written {instances}')
    for a, b in zip(tar_samples, nat_samples):
        check(list(a) == list(b), f'fields {list(a)} vs {list(b)}')
        for k, v in a.items():
            same = (np.array_equal(v, b[k]) and v.dtype == b[k].dtype
                    if isinstance(v, np.ndarray) else v == b[k])
            check(same, f'{a["__key__"]}.{k}: the native reader differs')
    del tar_samples, nat_samples

    pp = PostProcess(reso_encoder=256, reso_render=128, num_views_input=4,
                     num_views_sup=2)
    pp_secs = []

    def timed_pp(sample):
        t = time.perf_counter()
        out = pp(sample)
        pp_secs.append(time.perf_counter() - t)
        return out

    stream = load_wds_data(paths, batch_size=1, transform=timed_pp,
                           shuffle_buffer=4, seed=0)
    model_cfg, base_cfg, loss_cfg, opts = _train_cfgs(small=False)
    train_cfg = dataclasses.replace(base_cfg, use_fused_osg=True)
    tr = VAETrainer(model_cfg, train_cfg, loss_cfg, render_opts=opts,
                    seed=0, device='cuda')
    tr.init_state()
    before = {k: v.detach().clone() for k, v in tr.state.params.items()}
    gen = torch.Generator(device='cuda').manual_seed(2)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, losses, norms, launches, keys = [], [], [], [], []
    for i in range(steps):
        raw = next(stream)
        keys.append(raw['__key__'])
        check(raw['img_to_encoder'].shape == (1, 4, 256, 256, 10)
              and raw['nv_img'].shape == (1, 2, 128, 128, 3),
              f'streamed batch {raw["img_to_encoder"].shape}')
        batch = tr.prepare_batch(_flatten_views(raw))
        batch['step'] = float(i)
        torch.cuda.synchronize()
        FusedOSG.launches = FusedOSG.backward_launches = 0
        t = time.perf_counter()
        m = tr.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        launches.append((FusedOSG.launches, FusedOSG.backward_launches))
        losses.append(float(m['loss']))
        norms.append(float(m['grad_norm']))
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    changed = sum(not torch.equal(v, tr.state.params[k])
                  for k, v in before.items())
    trained = len(before)
    del tr, before, stream
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f'losses {losses}')
    check(all(n > 0 and math.isfinite(n) for n in norms),
          f'grad norms {norms}')
    check(changed > 0, 'no trained parameter changed')
    check(all(n == (8, 8) for n in launches),
          f'kernel 1/2 launches per step {launches}, expected 8/8')
    return dict(
        instances=instances, views=views, resolution=reso,
        shards=len(paths), shard_mib=round(shard_mb, 3),
        wds_create_s=round(write_s, 3),
        batches_per_s={'iter_shard': tar_bps, 'iter_shards_native': nat_bps},
        batch_instances=2,
        native_equals_tarfile=True,
        post_process_ms_per_instance=1e3 * sum(pp_secs) / len(pp_secs),
        post_process_instances=len(pp_secs),
        steps=steps, streamed_keys=keys, losses=losses, grad_norms=norms,
        params_changed=f'{changed} of {trained}',
        s_per_step=sum(secs[1:]) / len(secs[1:]), s_per_step_runs=secs,
        fused_osg_launches=sum(n[0] for n in launches),
        fused_osg_backward_launches=sum(n[1] for n in launches),
        launches_per_step=[list(n) for n in launches],
        peak_mem_gib_above_resident=round(peak, 3),
        resident_gib=round(resident / 2**30, 3))


class _FsdpSizes:
    """A stand-in mesh for the placement rules, which read axis sizes
    only: the sizes of a (1, 1, ``fsdp``, 1) mesh."""

    def __init__(self, fsdp):
        self.shape = (1, 1, fsdp, 1)


def _local_tensor(t):
    return t.to_local() if hasattr(t, 'to_local') else t


def parallel_vae_train(steps=3, timed=3):
    """The full-width VAE step of ``vae_train`` with the kernel pair
    (``use_fused_osg=True``) three ways from the same weights, batch and
    draws: built with ``mesh=make_mesh()`` — a one-rank NCCL mesh: the
    rank's slice is the whole batch and the grads pass an all-reduce over
    the one rank —; on that mesh with the parameters held in the module
    as their shards (``parallel/fsdp.py``) under the placements that
    ``param_sharding_rules`` gives an fsdp axis of 2, here one-way shards,
    so that every gather, reduce-scatter and saved-tensor recipe of the
    sharded path runs under NCCL; and without a mesh.  In turns for
    ``steps`` steps under ``torch.use_deterministic_algorithms`` (the
    card's default backward sums with atomics, so two runs of one code
    differ by about 1% of a grad's scale; kernels 1 and 2 are
    deterministic either way): the first step's grads, every loss and the
    parameters after each step must be equal (an all-reduce, a gather and
    a reduce-scatter over one rank are exact, and so is the division by
    one).  Then ``timed`` more meshed steps in the default mode (the
    first re-tunes cuDNN after the switch; s/step is the mean of the
    rest), and as many sharded ones.  Reported: the launches of kernels 1
    and 2 per meshed and per sharded step (counters set to 0 just before
    each step, read just after), s/step in both modes and the peak memory
    above the three resident trainers."""
    import warnings

    import torch
    from ln3diff_tpu_torch.data.synthetic import make_multiview_batch
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.parallel.mesh import (LocalMesh, is_distributed,
                                                 make_mesh,
                                                 param_sharding_rules)
    from ln3diff_tpu_torch.training.train_state import TrainState
    from ln3diff_tpu_torch.training.vae_trainer import VAETrainer

    model_cfg, base_cfg, loss_cfg, opts = _train_cfgs(small=False)
    train_cfg = dataclasses.replace(base_cfg, use_fused_osg=True)
    raw = make_multiview_batch(4, 256, 128, seed=0)
    mesh = make_mesh()
    check(is_distributed(mesh) and mesh.size() == 1
          and mesh.device_type == 'cuda', f'mesh {mesh}')
    runs, firsts, sharded = {}, {}, 0
    for name, m in (('mesh', mesh), ('sharded', mesh),
                    ('no_mesh', LocalMesh('cuda'))):
        tr = VAETrainer(model_cfg, train_cfg, loss_cfg, render_opts=opts,
                        seed=0, device='cuda', mesh=m)
        tr.init_state()
        if name == 'sharded':
            tr.state = TrainState.create(
                tr.model, tr.state.tx, ema_rates=tr.state.ema_rates,
                mesh=m, placements=param_sharding_rules(tr.model,
                                                        _FsdpSizes(2)))
            sharded = len(tr.state.sharded.dims)
        firsts[name] = {}
        _record_first_grads(tr.state, firsts[name])
        runs[name] = (tr, torch.Generator(device='cuda').manual_seed(1))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, det_secs, max_diff = [], [], []
    launches = {'mesh': [], 'sharded': []}
    losses = {name: [] for name in runs}

    def step(name, i):
        tr, gen = runs[name]
        batch = tr.prepare_batch(raw)
        batch['step'] = float(i)
        torch.cuda.synchronize()
        FusedOSG.launches = FusedOSG.backward_launches = 0
        t0 = time.perf_counter()
        m = tr.train_step(batch, generator=gen)
        torch.cuda.synchronize()
        if name in launches:
            launches[name].append((FusedOSG.launches,
                                   FusedOSG.backward_launches))
        losses[name].append(float(m['loss']))
        return time.perf_counter() - t0

    def params_diff(name):
        a = runs[name][0].state.params
        b = runs['no_mesh'][0].state.params
        return max(float((_local_tensor(a[k]) - b[k]).abs().max())
                   for k in b)

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            for i in range(steps):
                for name in runs:
                    s_ = step(name, i)
                    if name == 'mesh':
                        det_secs.append(s_)
                max_diff.append({n: params_diff(n)
                                 for n in ('mesh', 'sharded')})
        nondet = sorted({str(w.message)[:160] for w in caught
                         if 'deterministic' in str(w.message)})
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    grad_diff = {n: max(float((firsts[n][k] - g).abs().max())
                        for k, g in firsts['no_mesh'].items())
                 for n in ('mesh', 'sharded')}
    sharded_secs = []
    for i in range(timed):
        secs.append(step('mesh', steps + i))
        sharded_secs.append(step('sharded', steps + i))
    peak = (torch.cuda.max_memory_allocated() - resident) / 2**30
    del runs, firsts
    gc.collect()
    torch.cuda.empty_cache()
    check(not nondet, f'ops without a deterministic version: {nondet}')
    check(sharded > 0, 'no parameter sharded in the module')
    check(all(d == 0.0 for d in grad_diff.values())
          and all(d == 0.0 for row in max_diff for d in row.values())
          and losses['mesh'][:steps] == losses['no_mesh']
          and losses['sharded'][:steps] == losses['no_mesh'],
          f'meshed and sharded steps vs the step without a mesh: grads '
          f'{grad_diff}, params {max_diff}, losses {losses}')
    check(all(n == (8, 8) for ns in launches.values() for n in ns),
          f'kernel 1/2 launches per step {launches}, expected 8/8')
    check(all(math.isfinite(x) for ls in losses.values() for x in ls),
          f'losses {losses}')
    return dict(world_size=1, backend='nccl', steps=steps,
                sharded_in_module=sharded,
                first_grads_max_abs_diff=grad_diff,
                params_max_abs_diff_per_step=max_diff,
                tolerance='0 (equal, deterministic algorithms)',
                losses=losses,
                s_per_step=sum(secs[1:]) / len(secs[1:]),
                s_per_step_runs=secs,
                s_per_step_sharded=sum(sharded_secs[1:])
                / len(sharded_secs[1:]),
                s_per_step_sharded_runs=sharded_secs,
                s_per_step_deterministic_runs=det_secs,
                fused_osg_launches=sum(n[0] for n in launches['mesh']),
                fused_osg_backward_launches=sum(n[1]
                                                for n in launches['mesh']),
                launches_per_step={k: [list(n) for n in v]
                                   for k, v in launches.items()},
                peak_mem_gib_above_three_resident_trainers=round(peak, 3),
                resident_gib=round(resident / 2**30, 3))


def serving_mesh(prompt):

    """The full-width text→3D ``__call__`` (DDIM ``SERVING_STEPS``) with
    ``serving_mesh=make_mesh()``
    (the orbit's 24 frames and the 192³ σ grid over the one NCCL rank,
    gathered back), then the unsharded pipeline over the same modules on
    the same latents: the frames and the σ grid must agree within
    ``TOL_SERVING_MESH`` of scale; kernel 1 must read 75 launches in the
    sharded call (48 render + 27 σ chunks).  Then ``dit_pipeline_apply``
    at pp = 1 with 4 microbatches on an f32 copy of the full DiT-L/2
    against its plain forward (``TOL_PP1``)."""
    import torch
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.parallel.mesh import LocalMesh, make_mesh
    from ln3diff_tpu_torch.parallel.pipeline import dit_pipeline_apply
    from ln3diff_tpu_torch.pipeline import SamplerSpec, build_t23d_pipeline

    sampler = SamplerSpec(kind='ddim', num_steps=SERVING_STEPS)
    sharded, encode, modules = build_t23d_pipeline(
        'cuda', seed=0, serving_mesh=make_mesh(), sampler=sampler)
    plain, _, _ = build_t23d_pipeline('cuda', modules=modules,
                                      sampler=sampler)
    cond, uncond = encode(prompt)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_launches()
    t0 = time.perf_counter()
    out = sharded(cond, uncond, num_frames=24, render_resolution=192,
                  generator=torch.Generator(device='cuda').manual_seed(1))
    planes = out['planes'].to(torch.bfloat16)
    sigma = sharded.dispatch_mesh_sigma(planes, 192, smooth=True)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    counts = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    FusedOSG.launches = 0
    video = plain.render_orbit(planes, 24, render_resolution=192)
    sigma_plain = plain.dispatch_mesh_sigma(planes, 192, smooth=True)
    torch.cuda.synchronize()
    err_v = float((out['video'] - video).abs().max())
    err_s = float((sigma.float() - sigma_plain.float()).abs().max())
    scale_v = max(1.0, float(video.abs().max()))
    scale_s = max(1.0, float(sigma_plain.float().abs().max()))
    check(tuple(out['video'].shape) == (1, 24, 192, 192, 3), 'video shape')
    check(bool(torch.isfinite(out['video']).all()), 'frames not finite')
    check(err_v <= TOL_SERVING_MESH * scale_v,
          f'sharded frames vs unsharded: {err_v}')
    check(err_s <= TOL_SERVING_MESH * scale_s,
          f'sharded sigma grid vs unsharded: {err_s}')
    check(counts['fused_osg'] == 75, f'kernel 1 launched '
          f'{counts["fused_osg"]} times in the sharded call, expected 75')
    check(counts['fused_attention'] == counts['fused_qkv_attention'] ==
          counts['fused_osg_bwd'] == 0, f'other kernels launched {counts}')

    den = copy.deepcopy(modules['denoiser']).float()
    del sharded, plain, modules, out, video, sigma, sigma_plain
    torch.cuda.empty_cache()
    g = torch.Generator(device='cuda').manual_seed(2)
    x = torch.randn(4, 32, 32, 12, device='cuda', generator=g)
    t = torch.tensor([10.0, 250.0, 500.0, 990.0], device='cuda')
    ctx = {'crossattn': torch.randn(4, 77, 768, device='cuda', generator=g)}
    with torch.no_grad():
        want = den(x, t, ctx)
        got = dit_pipeline_apply(den, x, t, ctx, mesh=LocalMesh('cuda'),
                                 n_micro=4)
    err_pp = float((got - want).abs().max())
    scale_pp = max(1.0, float(want.abs().max()))
    check(err_pp <= TOL_PP1 * scale_pp,
          f'dit_pipeline_apply pp=1 vs plain forward: {err_pp}')
    del den
    torch.cuda.empty_cache()
    return dict(call_seconds=round(call_s, 3),
                fused_osg_launches=counts['fused_osg'],
                frames_max_abs_err=err_v, sigma_max_abs_err=err_s,
                tolerance=f'{TOL_SERVING_MESH} of scale',
                peak_mem_gib=round(peak, 3),
                dit_pipeline_pp1=dict(n_micro=4, batch=4, dtype='float32',
                                      max_abs_err=err_pp,
                                      tolerance=f'{TOL_PP1} of scale'))


def train_entries(workdir):
    """The five training CLIs in process with ``--device cuda`` under the
    one-rank NCCL group, at the presets' widths with the depths cut as
    listed (``sizes``), each for 2–3 steps into its own temporary log
    directory (removed after): ``vit_triplane_train`` (2 steps and a
    checkpoint, resumed to step 3, then ``--inference --save_latent``),
    ``vit_triplane_diffusion_train`` (the t23d DiT-L/2 preset, then
    ``--objective vpsde_joint``), ``vit_triplane_sit_train``,
    ``vit_triplane_cvD_train`` and ``vit_triplane_cldm_train`` (its random
    U-Net moved off the zero init, which would make the loss independent
    of the ControlNet: it stands in for a trained U-Net).  Per CLI: s/step
    (the trainer's ``train_step`` wrapped with a synchronising timer), the
    last losses and grad norm, the trained parameters the steps changed,
    the peak device memory above what was held before it.  Fails unless
    every training CLI's metrics are finite, its last grad norm is
    positive and a parameter changed."""
    import shutil

    import torch
    from ln3diff_tpu_torch.config import denoiser_preset, vae_preset
    from ln3diff_tpu_torch.models import layers
    from ln3diff_tpu_torch.models.unet import UNetConfig
    from ln3diff_tpu_torch.scripts import (vit_triplane_cldm_train,
                                           vit_triplane_cvD_train,
                                           vit_triplane_diffusion_train,
                                           vit_triplane_sit_train,
                                           vit_triplane_train)
    from ln3diff_tpu_torch.training import (ldm_trainer, lsgm_trainer,
                                            vae_trainer)

    vae_depth, dit_depth = 4, 8
    base_vae = vae_preset('objaverse')
    vae_cfg = dataclasses.replace(base_vae, dit2=dataclasses.replace(
        base_vae.dit2, depth=vae_depth))
    dit_cfg = dataclasses.replace(denoiser_preset('t23d-dit-l2'),
                                  depth=dit_depth, remat=True,
                                  remat_policy='dots')
    unet_cfg = UNetConfig(in_channels=4, out_channels=4, model_channels=320,
                          channel_mult=(1, 2), num_res_blocks=1,
                          context_dim=None)
    sizes = dict(
        vae=f'objaverse preset, DiT2-L/2 depth 24 -> {vae_depth}, 1 '
            f'instance of 4 views at 256^2, patch 32 of 128^2',
        dit=f't23d DiT-L/2 width 1024, depth 24 -> {dit_depth}, remat '
            f'dots, batch 8',
        lsgm=f'the cut VAE + U-Net-320 with channel_mult (1, 2, 4, 4) -> '
             f'(1, 2) and 1 res block per level',
        cldm='shapenet-unet (U-Net-320, full), batch 2')
    timers = {}

    def timed(cls, attr):
        fn = getattr(cls, attr)

        def run(self, *a, **k):
            first.setdefault(id(self), {
                n: v.detach().clone() for n, v in self.state.params.items()})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            timers.setdefault(current[0], []).append(
                time.perf_counter() - t0)
            return out
        setattr(cls, attr, run)
        return fn

    current = [None]
    first = {}     # the trained parameters before a trainer's first step
    zero_init = layers.zero_init_like_jax

    def zero_init_perturbed(model):
        zero_init(model)
        g = torch.Generator(device='cuda').manual_seed(2)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.02 * torch.randn(p.shape, generator=g,
                                          device=p.device, dtype=p.dtype))
        return model

    saved = [(c, a, timed(c, a)) for c, a in (
        (vae_trainer.VAETrainer, 'train_step'),
        (ldm_trainer.LDMTrainer, 'train_step'),
        (lsgm_trainer.LSGMTrainer, 'train_step'))]
    steps = ['--total_steps', '2', '--save_interval', '2',
             '--log_interval', '1', '--device', 'cuda']
    views = ['--batch_size', '1', '--num_views', '4',
             '--encoder_resolution', '256', '--render_resolution', '128']
    out = {}
    try:
        runs = [
            ('vit_triplane_train', lambda d: vit_triplane_train.run(
                steps + views + ['--preset', 'train/objaverse-vae',
                                 '--batch_size', '1', '--logdir', d],
                model_cfg=vae_cfg)),
            ('vit_triplane_train_resume', lambda d: vit_triplane_train.run(
                steps + views + ['--preset', 'train/objaverse-vae',
                                 '--batch_size', '1', '--logdir', d,
                                 '--resume_checkpoint', '1',
                                 '--total_steps', '3'],
                model_cfg=vae_cfg)),
            ('vit_triplane_train_inference', lambda d: vit_triplane_train.run(
                steps + views + ['--logdir', d, '--resume_checkpoint', '1',
                                 '--inference', '1', '--save_latent', '1'],
                model_cfg=vae_cfg)),
            ('vit_triplane_diffusion_train',
             lambda d: vit_triplane_diffusion_train.run(
                 steps + ['--preset', 'train/objaverse-dit', '--batch_size',
                          '8', '--logdir', d], den_cfg=dit_cfg)),
            ('vit_triplane_diffusion_train_vpsde_joint',
             lambda d: vit_triplane_diffusion_train.run(
                 steps + ['--objective', 'vpsde_joint', '--batch_size', '1',
                          '--logdir', d], vae_cfg=vae_cfg,
                 unet_cfg=unet_cfg)),
            ('vit_triplane_sit_train', lambda d: vit_triplane_sit_train.run(
                steps + ['--batch_size', '8', '--logdir', d],
                den_cfg=dit_cfg)),
            ('vit_triplane_cvD_train', lambda d: vit_triplane_cvD_train.run(
                steps + views + ['--logdir', d], model_cfg=vae_cfg)),
            ('vit_triplane_cldm_train', lambda d: vit_triplane_cldm_train.run(
                ['--device', 'cuda', '--total_steps', '3', '--batch_size',
                 '2', '--log_interval', '1', '--logdir', d])),
        ]
        logdir = None
        for name, fn in runs:
            if not name.startswith('vit_triplane_train_'):
                if logdir:
                    shutil.rmtree(logdir, ignore_errors=True)
                logdir = tempfile.mkdtemp(dir=workdir)
            current[0] = name
            gc.collect()       # the last CLI's trainer (reference cycles)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if name == 'vit_triplane_cldm_train':
                layers.zero_init_like_jax = zero_init_perturbed
            try:
                trainer, metrics = fn(logdir)
            finally:
                layers.zero_init_like_jax = zero_init
            torch.cuda.synchronize()
            secs = timers.get(name, [])
            losses = {k: v for k, v in metrics.items()
                      if 'loss' in k or k.endswith('mse')}
            check(all(math.isfinite(v) for v in metrics.values()),
                  f'{name}: metrics {metrics}')
            start = first.pop(id(trainer), None)
            changed = None
            if name != 'vit_triplane_train_inference':
                changed = sum(not torch.equal(v, trainer.state.params[n])
                              for n, v in start.items())
                check(metrics['grad_norm'] > 0 and changed > 0,
                      f'{name}: grad norm {metrics["grad_norm"]}, '
                      f'{changed} parameters changed')
            del start
            params = sum(p.numel() for p in trainer.state.params.values())
            out[name] = dict(
                seconds=round(time.perf_counter() - t0, 3),
                step=trainer.state.step, trained_params=params,
                s_per_step=(sum(secs[1:]) / len(secs[1:]) if len(secs) > 1
                            else (secs[0] if secs else None)),
                s_per_step_runs=secs, last_losses=losses,
                grad_norm=metrics.get('grad_norm'), params_changed=changed,
                peak_mem_gib=round((torch.cuda.max_memory_allocated()
                                    - before) / 2**30, 3),
                held_before_gib=round(before / 2**30, 3))
            if name == 'vit_triplane_train_inference':
                files = sorted(os.listdir(os.path.join(logdir, 'eval')))
                check('latent_0000.npy' in files and len(files) == 9,
                      f'inference wrote {files}')
                out[name]['eval_files'] = len(files)
            del trainer
        shutil.rmtree(logdir, ignore_errors=True)
        check(out['vit_triplane_train']['step'] == 2
              and out['vit_triplane_train_resume']['step'] == 3,
              'checkpoint resume')
    finally:
        for cls, attr, fn in saved:
            setattr(cls, attr, fn)
    torch.cuda.empty_cache()
    return dict(sizes=sizes, clis=out)


# -- evaluation, the sgm stack, profiling and the demos ----------------------

def _inception_state_dict(seed=11):
    """A pytorch-fid-layout ``Inception3`` state dict with random weights
    (He-scaled convs, BN statistics and affine off their init, an
    auxiliary classifier and ``num_batches_tracked`` as the released file
    has them)."""
    import torch
    from ln3diff_tpu_torch.evaluation.inception import InceptionV3
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith('num_batches_tracked'):
            sd[k] = torch.tensor(0)
        elif k.endswith('conv.weight'):
            sd[k] = torch.randn(v.shape, generator=g) * math.sqrt(
                2.0 / v[0].numel())
        elif k.endswith('running_var') or k.endswith('bn.weight'):
            sd[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k == 'fc.weight':
            sd[k] = torch.randn(v.shape, generator=g) / math.sqrt(v.shape[1])
        else:
            sd[k] = torch.randn(v.shape, generator=g) * 0.1
    sd['AuxLogits.conv0.conv.weight'] = torch.zeros(128, 768, 1, 1)
    sd['AuxLogits.fc.weight'] = torch.zeros(1000, 768)
    return sd


def _eval_images(n, reso, seed):
    """``n`` uint8 images of ``reso``²: 8×8 blocks of random colour with
    pixel noise, from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.int16)
    img = np.repeat(np.repeat(base, reso // 8, axis=1), reso // 8, axis=2)
    img += rng.integers(-12, 13, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def evaluation(workdir, n=1024, reso=256):
    """The evaluator's two extractors card vs CPU on 8 images (pool3,
    logits and the 2023-d spatial features; the CLIP tower's three
    outputs; ``TOL_EVAL`` of each output's scale), then the evaluator CLI
    in process with ``--device cuda`` and ``--inception_weights`` (a
    pytorch-fid-layout state dict written first, its ``AuxLogits.*``
    included) on ``n`` + ``n`` uint8 images of ``reso``² (the sample set
    is the reference set with ±20 levels of noise), timed by stage;
    FID(ref, ref) from the reference features < 1e-3, FID(ref, sample) >
    0; then once with ``--extractor clip``.  No kernel runs on this path
    (none does in JAX)."""
    import numpy as np
    import torch
    from ln3diff_tpu_torch.evaluation import metrics as M
    from ln3diff_tpu_torch.scripts import evaluator

    weights = os.path.join(workdir, 'pt_inception-random.pth')
    torch.save(_inception_state_dict(), weights)
    ref = _eval_images(n, reso, 31)
    noise = np.random.default_rng(32).integers(-20, 21, ref.shape,
                                               dtype=np.int16)
    smp = np.clip(ref.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    del noise
    ref_npz = os.path.join(workdir, 'ref.npz')
    smp_npz = os.path.join(workdir, 'sample.npz')
    np.savez(ref_npz, arr_0=ref)
    np.savez(smp_npz, arr_0=smp)

    # the extractors card vs CPU
    errs = {}
    for name, make in (('inception', lambda d: M.make_inception_feature_fn(
                            weights=weights, batch_size=8, device=d)),
                       ('clip', lambda d: M.make_clip_feature_fn(
                           batch_size=8, device=d))):
        card, cpu = make('cuda')(ref[:8]), make('cpu')(ref[:8])
        for part, a, b in zip(('pool', 'logits', 'spatial'), card, cpu):
            check(a.shape == b.shape and np.isfinite(a).all(),
                  f'{name} {part}: {a.shape} vs {b.shape}')
            err = float(np.abs(a - b).max())
            scale = max(1.0, float(np.abs(b).max()))
            check(err <= TOL_EVAL * scale,
                  f'{name} {part} card vs CPU: {err} > {TOL_EVAL}·{scale}')
            errs[f'{name}_{part}'] = err

    # the CLI, each stage timed through the metrics module it calls
    stages, feats = {}, []
    orig = {k: getattr(M, k) for k in (
        'make_inception_feature_fn', 'compute_fid', 'inception_score',
        'precision_recall')}

    def timed(name, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            key = name if name not in stages else f'{name}_2'
            stages[key] = round(time.perf_counter() - s, 3)
            return out
        return run

    def make_fn(*a, **k):
        fn = orig['make_inception_feature_fn'](*a, **k)

        def feat(images):
            out = timed('features_ref' if not feats else 'features_sample',
                        fn)(images)
            feats.append(out)
            return out
        return feat

    M.make_inception_feature_fn = make_fn
    M.compute_fid = timed('fid', orig['compute_fid'])
    M.inception_score = timed('inception_score', orig['inception_score'])
    M.precision_recall = timed('precision_recall', orig['precision_recall'])
    zero_kernel_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        res, _ = _run_cli(evaluator.main, [
            ref_npz, smp_npz, '--inception_weights', weights,
            '--device', 'cuda'])
    finally:
        for k, v in orig.items():
            setattr(M, k, v)
    cli_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    stages['sfid'] = stages.pop('fid_2')
    stages['npz_load_and_other'] = round(cli_s - sum(stages.values()), 3)
    fid_self = orig['compute_fid'](feats[0][0], feats[0][0])
    check(abs(fid_self) < 1e-3, f'FID(ref, ref) = {fid_self}')
    check(res.fid > 0 and np.isfinite(res.fid), f'FID {res.fid}')
    check(res.sfid is not None and np.isfinite(res.sfid), f'sFID {res.sfid}')
    check(np.isfinite(res.inception_score), 'IS not finite')
    check(0 <= res.precision <= 1 and 0 <= res.recall <= 1, 'P/R range')
    feat_s = stages['features_ref'] + stages['features_sample']

    t0 = time.perf_counter()
    clip_res, _ = _run_cli(evaluator.main, [ref_npz, smp_npz, '--extractor',
                                            'clip', '--device', 'cuda'])
    clip_s = time.perf_counter() - t0
    check(clip_res.fid > 0 and np.isfinite(clip_res.fid)
          and np.isfinite(clip_res.sfid), f'clip {clip_res}')
    return dict(images=f'{n} + {n} uint8 {reso}^2 (sample = ref + '
                       f'uniform noise of +-20 levels)',
                weights='random, pytorch-fid layout with AuxLogits '
                        '(torch.save, read with weights_only=True)',
                card_vs_cpu_max_abs_err=errs, tol=TOL_EVAL,
                inception=dict(fid=res.fid, sfid=res.sfid,
                               inception_score=res.inception_score,
                               precision=res.precision, recall=res.recall,
                               fid_ref_ref=fid_self),
                cli_seconds=round(cli_s, 3), seconds_by_stage=stages,
                images_per_s=round(2 * n / feat_s, 1),
                peak_mem_gib=round(peak, 3),
                clip=dict(fid=clip_res.fid, sfid=clip_res.sfid,
                          inception_score=clip_res.inception_score,
                          seconds=round(clip_s, 3)),
                kernel_launches=no_kernel_launches('evaluation'))


def _sgm_mappings():
    """The t23d EDM stack and the multi-view flow-matching stack of the
    release configs (``txt2img-clipl-compat.yaml``,
    ``mv23d-plucker-...-fm.yaml``) as parsed mappings."""
    sgm, diff = 'sgm.modules', 'sgm.modules.diffusionmodules'
    t23d = {'ldm_configs': {
        'scheduler_config': {
            'target': 'sgm.lr_scheduler.LambdaLinearScheduler',
            'params': {'warm_up_steps': [10000],
                       'cycle_lengths': [10000000000000],
                       'f_start': [1e-6], 'f_max': [1.0], 'f_min': [1.0]}},
        'denoiser_config': {
            'target': f'{diff}.denoiser.DiscreteDenoiser',
            'params': {'num_idx': 1000, 'scaling_config': {
                'target': f'{diff}.denoiser_scaling.EpsScaling'}}},
        'conditioner_config': {
            'target': f'{sgm}.GeneralConditioner',
            'params': {'emb_models': [{
                'is_trainable': False, 'input_key': 'caption',
                'ucg_rate': 0.1,
                'target': f'{sgm}.encoders.modules.FrozenCLIPEmbedder',
                'params': {'always_return_pooled': True}}]}},
        'loss_fn_config': {
            'target': f'{diff}.loss.StandardDiffusionLoss',
            'params': {'loss_weighting_config': {
                'target': f'{diff}.loss_weighting.EpsWeighting'},
                'sigma_sampler_config': {
                    'target': f'{diff}.sigma_sampling.DiscreteSampling',
                    'params': {'num_idx': 1000}}}},
        'sampler_config': {
            'target': f'{diff}.sampling.EulerEDMSampler',
            'params': {'num_steps': 250, 'guider_config': {
                'target': f'{diff}.guiders.VanillaCFG',
                'params': {'scale': 6.5}}}}}}
    fm = {'ldm_configs': {
        'conditioner_config': {
            'target': f'{sgm}.GeneralConditioner',
            'params': {'emb_models': [{
                'is_trainable': False, 'input_key': 'img-c',
                'ucg_rate': 0.1,
                'target': f'{sgm}.encoders.modules.'
                          'FrozenDinov2ImageEmbedderMVPlucker',
                'params': {'arch': 'vitb', 'n_cond_frames': 4}}]}},
        'loss_fn_config': {
            'target': f'{diff}.loss.FMLoss',
            'params': {'transport_config': {
                'target': 'transport.create_transport',
                'params': {'snr_type': 'lognorm'}}}}},
        'guider_config': {'target': f'{diff}.guiders.VanillaCFG',
                          'params': {'scale': 5.0}}}
    return t23d, fm


def sgm_stack(B=4, steps=25):
    """The sgm stacks from parsed mappings (``load_ldm_configs`` without
    yaml): the t23d stack's conditioner (the full-width CLIP-L text tower,
    random) encodes two prompts; its EDM loss and backward on the t23d
    DiT-L/2 at batch ``B`` (f32 parameters, bf16 autocast); its Euler
    sampler for ``steps`` CFG-6.5 steps (ms per step); the flow-matching
    stack's loss on DiT-I23D-L/2 at batch ``B``.  Everything finite; no
    kernel (none in JAX)."""
    import torch
    from ln3diff_tpu_torch import sgm_config
    from ln3diff_tpu_torch.config import denoiser_preset
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent
    from ln3diff_tpu_torch.models.layers import random_init_

    zero_kernel_launches()
    t23d_map, fm_map = _sgm_mappings()
    t23d = sgm_config.load_ldm_configs(t23d_map)
    fm = sgm_config.load_ldm_configs(fm_map)
    check(t23d.loss.kind == 'edm' and t23d.sampler.guider.scale == 6.5
          and t23d.scheduler(5000) < 1.0 and t23d.denoiser.scaling.kind
          == 'eps', 't23d stack fields')
    check(fm.loss.kind == 'flow_matching' and fm.guider.scale == 5.0
          and fm.conditioner.embedders[0].maker == 'dino_mv_plucker',
          'fm stack fields')
    g = torch.Generator(device='cuda').manual_seed(21)
    secs = {}

    t0 = time.perf_counter()
    cond = t23d.conditioner.build(g, device='cuda')
    c, uc = cond.get_unconditional_conditioning(
        {'caption': ['a red wooden chair', 'a blue sports car']})
    torch.cuda.synchronize()
    secs['conditioner_build_and_encode'] = round(time.perf_counter() - t0, 3)
    check(tuple(c['crossattn'].shape) == (2, 77, 768)
          and tuple(c['vector'].shape) == (2, 768), 'conditioner shapes')
    check(all(bool(torch.isfinite(v).all()) for v in (*c.values(),
                                                       *uc.values())),
          'conditioning not finite')
    del cond

    def network_of(model):
        def network(x, t, ctx):
            with torch.autocast('cuda', dtype=torch.bfloat16):
                return model(x, t.float(), ctx).float()
        return network

    with torch.device('cuda'):
        model = DiT_TriLatent(denoiser_preset('t23d-dit-l2')).cuda()
    random_init_(model, g)
    net = network_of(model)
    x0 = torch.randn((B, 32, 32, 12), generator=g, device='cuda')
    ctx = {'crossattn': c['crossattn'][torch.arange(B) % 2]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = t23d.loss.make_loss_fn(t23d.denoiser)(net, x0, ctx,
                                                   generator=g)
    losses.mean().backward()
    torch.cuda.synchronize()
    secs['edm_loss_and_backward'] = round(time.perf_counter() - t0, 3)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    gnorm = float(torch.sqrt(sum((gr.float()**2).sum() for gr in grads)))
    check(bool(torch.isfinite(losses).all()) and math.isfinite(gnorm)
          and gnorm > 0, f'edm loss {losses} grad norm {gnorm}')
    model.zero_grad(set_to_none=True)

    spec = dataclasses.replace(t23d.sampler, num_steps=steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        x = spec.sample(t23d.denoiser, net, (1, 32, 32, 12),
                        {'crossattn': c['crossattn'][:1]},
                        {'crossattn': uc['crossattn'][:1]}, generator=g,
                        device='cuda')
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    check(tuple(x.shape) == (1, 32, 32, 12)
          and bool(torch.isfinite(x).all()), 'euler sample')
    del model, net
    gc.collect()
    torch.cuda.empty_cache()

    cfg = denoiser_preset('i23d-pixart-l2')
    with torch.device('cuda'):
        model = DiT_TriLatent(cfg).cuda()
    random_init_(model, g)
    ctx = {'crossattn': torch.randn((B, 257, 1024), generator=g,
                                    device='cuda'),
           'vector': torch.randn((B, 768), generator=g, device='cuda'),
           'dino': torch.randn((B, 257, cfg.dino_dim), generator=g,
                               device='cuda')}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        fm_losses = fm.loss.make_loss_fn()(network_of(model), x0, ctx,
                                           generator=g)
    torch.cuda.synchronize()
    secs['fm_loss'] = round(time.perf_counter() - t0, 3)
    check(tuple(fm_losses.shape) == (B,)
          and bool(torch.isfinite(fm_losses).all()), f'fm loss {fm_losses}')
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(stacks='t23d EDM (CLIP-L text, DiT-L/2) and mv23d FM, '
                       'from mappings built in Python',
                batch=B, edm_loss=[float(v) for v in losses],
                edm_grad_norm=gnorm, fm_loss=[float(v) for v in fm_losses],
                euler_steps=steps, euler_ms_per_step=round(
                    sample_s * 1e3 / steps, 3),
                sample_abs_max=float(x.abs().max()), seconds_by_stage=secs,
                kernel_launches=no_kernel_launches('sgm_stack'))


def profiling_trace(workdir, calls=3):
    """``utils.profiling.trace`` around ``calls`` calls of the fused
    DiT-L/2 denoiser (``fused_attention=True``, bf16, CFG-doubled batch
    2) inside an ``annotate`` range: the trace file must hold the range,
    and kernel 3 must launch once per block per call (24 per call, its
    counter set to 0 just before the traced block).  The trace's CUDA
    kernel events are reported, not checked: the profiler at times reads
    no device activity on this machine."""
    import torch
    from ln3diff_tpu_torch.config import denoiser_preset
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent
    from ln3diff_tpu_torch.models.layers import random_init_
    from ln3diff_tpu_torch.ops.fused_attention import FusedAttention
    from ln3diff_tpu_torch.utils import profiling

    cfg = dataclasses.replace(denoiser_preset('t23d-dit-l2'),
                              exact_gelu=False, fused_attention=True)
    g = torch.Generator(device='cuda').manual_seed(41)
    with torch.device('cuda'):
        model = DiT_TriLatent(cfg).cuda()
    random_init_(model, g)
    model = model.to(cfg.dtype).eval()
    x = torch.randn((2, 32, 32, 12), generator=g, device='cuda')
    t = torch.full((2,), 500.0, device='cuda')
    ctx = {'crossattn': torch.randn((2, 77, 768), generator=g,
                                    device='cuda')}
    with torch.no_grad():
        model(x, t, ctx)                       # warm-up, outside the trace
        torch.cuda.synchronize()
        zero_kernel_launches()
        t0 = time.perf_counter()
        with profiling.trace(os.path.join(workdir, 'trace')) as prof:
            with profiling.annotate('ln3diff_dit_calls'):
                for _ in range(calls):
                    out = model(x, t, ctx)
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        launches = FusedAttention.launches
        check(launches == calls * cfg.depth,
              f'kernel 3 launched {launches} times, want {calls * cfg.depth}')
        check(bool(torch.isfinite(out).all()), 'denoiser output not finite')
        ms = profiling.benchmark_fn(lambda: model(x, t, ctx), warmup=1,
                                    iters=3) * 1e3
    with open(prof.trace_path) as f:
        events = json.load(f)['traceEvents']
    check(any(e.get('name') == 'ln3diff_dit_calls' for e in events),
          'the annotate range is not in the trace')
    kernels = [e for e in events if e.get('cat') == 'kernel']
    attn = [e for e in kernels if 'attention' in e.get('name', '').lower()]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(denoiser='t23d DiT-L/2, fused attention, bf16, batch 2',
                calls=calls, traced_seconds=round(traced_s, 3),
                ms_per_call_untraced=round(ms, 3),
                fused_attention_launches=launches,
                trace_mib=round(os.path.getsize(prof.trace_path) / 2**20, 3),
                trace_cuda_kernel_events=len(kernels),
                trace_attention_kernel_events=len(attn),
                trace_kernel_ms=round(sum(e.get('dur', 0) for e in kernels)
                                      / 1e3, 3))


def _timed_method(cls, name, seconds):
    """Wrap ``cls.name`` with a synchronising timer adding into
    ``seconds[name]``; returns the original, to put back."""
    import torch
    orig = getattr(cls, name)

    def run(*a, **k):
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - s
        return out
    setattr(cls, name, run)
    return orig


def two_stage_demo(workdir):
    """The two-stage demo as a user runs it: the port's VAE and diffusion
    training entries for 2 steps each into temporary log directories
    (``--vae objaverse-s --encoder_resolution 128 --num_views 4``;
    ``--denoiser_scale DiT-B/2 --latent_size 16
    --triplane_scaling_divider 1.0``), then ``demo_two_stage`` at its
    defaults (100 FM steps, 8 frames of 64², a 96³ grid).  Checked: the
    restored steps equal the entries' steps, finite frames in [-1, 1],
    the OBJ parses; no kernel (the entries train the plain route and the
    demo renders plainly, as in JAX)."""
    import torch
    from ln3diff_tpu_torch import pipeline as P
    from ln3diff_tpu_torch.scripts import (demo_two_stage,
                                           vit_triplane_diffusion_train,
                                           vit_triplane_train)

    zero_kernel_launches()
    vae_dir, ldm_dir = (os.path.join(workdir, d) for d in ('vae', 'ldm'))
    out_dir = os.path.join(workdir, 'demo')
    common = ['--device', 'cuda', '--total_steps', '2', '--save_interval',
              '2', '--log_interval', '1']
    secs = {}
    t0 = time.perf_counter()
    (vae_tr, vae_m), _ = _run_cli(vit_triplane_train.run, common + [
        '--logdir', vae_dir, '--vae', 'objaverse-s', '--encoder_resolution',
        '128', '--num_views', '4'])
    secs['vae_entry'] = round(time.perf_counter() - t0, 3)
    vae_step = int(vae_tr.state.step)
    del vae_tr
    t0 = time.perf_counter()
    (ldm_tr, ldm_m), _ = _run_cli(vit_triplane_diffusion_train.run, common + [
        '--logdir', ldm_dir, '--denoiser_scale', 'DiT-B/2', '--latent_size',
        '16', '--triplane_scaling_divider', '1.0'])
    secs['ldm_entry'] = round(time.perf_counter() - t0, 3)
    ldm_step = int(ldm_tr.state.step)
    del ldm_tr
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(v) for v in (*vae_m.values(), *ldm_m.values())),
          f'entry metrics {vae_m} {ldm_m}')

    inner = {}
    origs = {k: _timed_method(P.TextTo3DPipeline, k, inner)
             for k in ('sample_latents', 'render_orbit',
                       'dispatch_mesh_sigma')}
    t0 = time.perf_counter()
    try:
        res, _ = _run_cli(demo_two_stage.main, [
            '--vae_logdir', vae_dir, '--ldm_logdir', ldm_dir, '--outdir',
            out_dir, '--device', 'cuda'])
    finally:
        for k, v in origs.items():
            setattr(P.TextTo3DPipeline, k, v)
    secs['demo'] = round(time.perf_counter() - t0, 3)
    secs.update({f'demo_{k}': round(v, 3) for k, v in inner.items()})
    check((res['vae_step'], res['ldm_step']) == (vae_step, ldm_step) == (2, 2),
          f'restored steps {res["vae_step"]}, {res["ldm_step"]}')
    video = res['out']['video'].float()
    check(tuple(video.shape) == (1, 8, 64, 64, 3), f'video {video.shape}')
    vmin, vmax = float(video.min()), float(video.max())
    check(bool(torch.isfinite(video).all()) and -1.0 <= vmin
          and vmax <= 1.0, f'frames [{vmin}, {vmax}]')
    check(len(res['frames']) == 8 and all(os.path.exists(p)
                                          for p in res['frames']),
          'frame files')
    verts, faces = res['out']['mesh']
    check(obj_counts(res['mesh_path']) == (len(verts), len(faces)),
          'OBJ does not parse back')
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return dict(entries='vit_triplane_train (objaverse-s, 4 views of 128^2)'
                        ' and vit_triplane_diffusion_train (DiT-B/2 over '
                        '16^2 x 12), 2 steps each',
                demo='100 FM steps, cfg 1.0, 8 frames of 64^2, 96^3 grid',
                restored_steps=dict(vae=vae_step, ldm=ldm_step),
                frames_range=[vmin, vmax], triangles=len(faces),
                seconds_by_stage=secs,
                kernel_launches=no_kernel_launches('two_stage_demo'))


def _avi_frame_count(path):
    import struct
    with open(path, 'rb') as f:
        data = f.read()
    check(data[:4] == b'RIFF' and data[8:12] == b'AVI ', f'{path}: no AVI')
    i = data.rindex(b'idx1')
    (n,) = struct.unpack('<I', data[i + 4:i + 8])
    return sum(data[i + 8 + 16 * e:i + 12 + 16 * e] == b'00dc'
               for e in range(n // 16))


def gradio_i23d(workdir, frames=12, res=128, grid=128):
    """The image→3D demo's command-line fallback (``gradio`` made
    unimportable) at its defaults — the random ``i23d-pixart-l2`` DiT in
    bf16, the ``objaverse-s`` VAE, CLIP ViT-L/14, 75 FM steps at CFG 4.0,
    ``frames`` frames of ``res``², a ``grid``³ σ grid, the render and the
    σ query through kernel 1 — over an ``--image_dir`` of 2 PNGs of 512²,
    then once on one image with ``--int8_dit``.  Kernel 1 must launch
    ``frames``·2 + ``grid``³/2^18 = 32 times per image (its counter set
    to 0 before each image, read after); each image's frames, AVI and OBJ
    are checked.  Seconds per image and per runner build."""
    import numpy as np
    import torch
    from PIL import Image
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.scripts import gradio_app

    img_dir = os.path.join(workdir, 'images')
    os.makedirs(img_dir)
    imgs = _eval_images(2, 512, 51)
    for i, im in enumerate(imgs):
        Image.fromarray(im).save(os.path.join(img_dir, f'view{i}.png'))
    want = frames * 2 + -(-grid**3 // 2**18)
    builds, per_image = [], []
    orig_build = gradio_app.build_runner

    def build(args, **kw):
        torch.cuda.synchronize()
        s = time.perf_counter()
        run = orig_build(args, **kw)
        torch.cuda.synchronize()
        builds.append(round(time.perf_counter() - s, 3))

        def timed_run(image, outdir, tag='out'):
            torch.cuda.synchronize()
            FusedOSG.launches = 0
            s = time.perf_counter()
            out = run(image, outdir, tag)
            torch.cuda.synchronize()
            per_image.append(dict(tag=tag, int8=args.int8_dit,
                                  seconds=round(time.perf_counter() - s, 3),
                                  fused_osg_launches=FusedOSG.launches))
            return out
        return timed_run

    saved = sys.modules.get('gradio', False)
    sys.modules['gradio'] = None
    gradio_app.build_runner = build
    out_dir = os.path.join(workdir, 'out')
    try:
        written, _ = _run_cli(gradio_app.main, [
            '--image_dir', img_dir, '--outdir', out_dir, '--device', 'cuda'])
        written8, _ = _run_cli(gradio_app.main, [
            '--image', os.path.join(img_dir, 'view0.png'), '--outdir',
            os.path.join(workdir, 'out_int8'), '--device', 'cuda',
            '--int8_dit'])
    finally:
        gradio_app.build_runner = orig_build
        if saved is False:
            sys.modules.pop('gradio', None)
        else:
            sys.modules['gradio'] = saved
    check(len(written) == 2 and len(written8) == 1, 'images run')
    triangles = []
    for tag, paths, mesh in written + written8:
        outdir = os.path.dirname(mesh)
        check(len(paths) == frames and all(os.path.exists(p)
                                           for p in paths), f'{tag} frames')
        check(_avi_frame_count(os.path.join(outdir, f'{tag}.avi')) == frames,
              f'{tag} AVI frames')
        triangles.append(obj_counts(mesh)[1])
    for rec in per_image:
        check(rec['fused_osg_launches'] == want,
              f'kernel 1 launched {rec["fused_osg_launches"]} times for '
              f'{rec["tag"]}, want {want}')
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runner='i23d-pixart-l2 DiT bf16 (and W8A8 int8), '
                       'objaverse-s VAE, CLIP ViT-L/14 f32, random weights',
                call=f'75 FM steps, cfg 4.0, {frames} frames of {res}^2, '
                     f'{grid}^3 sigma grid',
                images='2 PNGs of 512^2 through RealDataset, then one with '
                       '--int8_dit',
                per_image=per_image, build_seconds=builds,
                triangles=triangles,
                fused_osg_launches_per_image=want)


def main():
    # The tokenizer's hash fallback is salted per process, and the small
    # text→3D model's decoder is ill-conditioned for some prompts' token
    # ids (its latents reach a scale of several hundred): run under one
    # fixed salt, so that every run encodes every prompt alike.
    if os.environ.get('PYTHONHASHSEED') != '0':
        os.execve(sys.executable, [sys.executable] + sys.argv,
                  dict(os.environ, PYTHONHASHSEED='0'))
    faulthandler.dump_traceback_later(1100, exit=True)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import ln3diff_tpu_torch  # noqa: F401  (fails outside the repository)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. device
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ''
    phase_done('device', t0, name=name, count=count, nvidia_smi=smi_line,
               torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build every source: the kernels with nvcc, the mesh code and the
    # shard reader with g++
    t0 = time.perf_counter()
    from ln3diff_tpu_torch.ops._build import build_all
    builds = build_all()
    phase_done('build', t0, sources=[
        dict(name=b.name, path=os.path.relpath(b.path, here),
             compile_seconds=round(b.seconds, 3),
             ptxas=[ln for ln in b.log.splitlines() if 'ptxas' in ln])
        for b in builds])

    # 3. each kernel against its plain version
    t0 = time.perf_counter()
    checks = kernel_check()
    phase_done('kernel_check', t0)
    t0 = time.perf_counter()
    attn_checks = attention_check()
    phase_done('attention_check', t0)
    t0 = time.perf_counter()
    qkv_checks = qkv_attention_check()
    phase_done('qkv_attention_check', t0)
    t0 = time.perf_counter()
    bwd_checks, bwd_autograd = osg_backward_check()
    phase_done('osg_backward_check', t0)

    # 4. small models: card vs CPU
    t0 = time.perf_counter()
    small = small_reference()
    phase_done('small_reference', t0, **small)
    t0 = time.perf_counter()
    small_samplers = small_reference_samplers()
    phase_done('small_reference_samplers', t0, **small_samplers)
    t0 = time.perf_counter()
    small_train = small_train_reference()
    phase_done('small_train_reference', t0, **small_train)

    # 5. the main path at full width, random weights
    from ln3diff_tpu_torch.ops.fused_attention import (FusedAttention,
                                                       FusedQKVAttention)
    from ln3diff_tpu_torch.ops.fused_render import FusedOSG
    from ln3diff_tpu_torch.pipeline import build_t23d_pipeline
    t0 = time.perf_counter()
    pipe, encode, modules = build_t23d_pipeline('cuda', seed=0)
    phase_done('pipeline_build', t0, weights='random (torch.Generator '
               'seed 0); DiT-L/2 bf16 tanh-GELU, DiT2-L/2 VAE decoder bf16, '
               'CLIP-L text f32; ddim250, cfg 6.5, 24 x 192^2 orbit, '
               '64+64 samples, bf16 planes, 192^3 sigma grid')

    walls = {'dit_sample': 0.0, 'vae_decode': 0.0, 'render': 0.0}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            walls[key] += time.perf_counter() - s
            return out
        return run

    pipe.denoiser_fn = timed('dit_sample', pipe.denoiser_fn)
    pipe.decode_fn = timed('vae_decode', pipe.decode_fn)
    pipe.render_fn = timed('render', pipe.render_fn)

    prompt = 'a red wooden chair with four legs'
    t0 = time.perf_counter()
    cond, uncond = encode(prompt)
    text_s = time.perf_counter() - t0

    FusedOSG.launches = FusedAttention.launches = 0
    FusedQKVAttention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t_main = time.perf_counter()
    out = pipe(cond, uncond, batch=1, num_frames=24, render_resolution=192,
               generator=torch.Generator(device='cuda').manual_seed(1))
    torch.cuda.synchronize()
    render_launches = FusedOSG.launches
    check(FusedAttention.launches == 0,
          'the first path (fused_attention=False) launched fused_attention')
    check(FusedQKVAttention.launches == 0,
          'the first path launched fused_qkv_attention')
    FusedOSG.launches = 0
    t1 = time.perf_counter()
    sigma = pipe.dispatch_mesh_sigma(out['planes'].to(torch.bfloat16), 192,
                                     smooth=True)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t1
    query_launches = FusedOSG.launches
    main_s = time.perf_counter() - t_main

    video, latents = out['video'], out['latents']
    check(tuple(latents.shape) == (1, 32, 32, 12), 'latent shape')
    check(tuple(out['planes'].shape) == (1, 3, 128, 128, 32), 'plane shape')
    check(tuple(video.shape) == (1, 24, 192, 192, 3), 'video shape')
    check(tuple(sigma.shape) == (192**3,), 'sigma grid shape')
    check(bool(torch.isfinite(latents).all()), 'latents not finite')
    check(bool(torch.isfinite(out['planes']).all()), 'planes not finite')
    check(bool(torch.isfinite(video).all()), 'frames not finite')
    vmin, vmax = float(video.min()), float(video.max())
    check(-1.01 <= vmin and vmax <= 1.01, f'frames out of range '
          f'[{vmin}, {vmax}]')
    check(bool(torch.isfinite(sigma).all()), 'sigma grid not finite')
    check(render_launches > 0, 'render did not launch fused_osg')
    check(query_launches > 0, 'sigma query did not launch fused_osg')
    phase_done('pipeline', t0, seconds_by_phase=dict(
        text_encode=round(text_s, 3),
        dit_sample=round(walls['dit_sample'], 3),
        vae_decode=round(walls['vae_decode'], 3),
        render=round(walls['render'], 3), sigma_query=round(query_s, 3)),
        main_path_seconds=round(main_s, 3),
        fused_osg_launches=dict(render=render_launches,
                                query=query_launches),
        frames_range=[vmin, vmax],
        latents_abs_max=float(latents.abs().max()),
        sigma_range=[float(sigma.min()), float(sigma.max())],
        peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))

    # 6. the mesh stage on an analytic sphere, colours from real planes
    t0 = time.perf_counter()
    mesh_res = mesh_check(pipe._mesh_decoder(out['planes'].to(
        torch.bfloat16)))
    phase_done('mesh_check', t0, **mesh_res)
    del out, video, latents, sigma, pipe
    torch.cuda.empty_cache()

    # 7. the serving call at full width: fused attention, mesh file
    t0 = time.perf_counter()
    plain_denoiser = modules['denoiser']
    modules = dict(modules, denoiser=fused_denoiser(plain_denoiser))
    serving, _ = serving_pipeline(modules, prompt)
    phase_done('serving_pipeline', t0, **serving)

    # 8. a DDIM step of each denoiser under the profiler
    t0 = time.perf_counter()
    profile = dit_profile({'plain_attention': plain_denoiser,
                           'fused_attention': modules['denoiser']},
                          cond, uncond)
    phase_done('dit_profile', t0, **profile)

    # 9. the text→3D call with DPM-Solver++ and PLMS, with the int8 DiT,
    # with explicit cameras and with the frames folded into the ray axis
    t0 = time.perf_counter()
    samplers = t23d_samplers(modules, prompt)
    phase_done('t23d_samplers', t0, **samplers)
    t0 = time.perf_counter()
    int8 = t23d_int8(dict(modules, denoiser=plain_denoiser), modules, cond,
                     uncond, prompt)
    phase_done('t23d_int8', t0, sizes=CUT, **int8)
    t0 = time.perf_counter()
    orbit = orbit_options(modules, cond, uncond)
    phase_done('orbit_options', t0, **orbit)
    del modules, plain_denoiser, cond, uncond
    torch.cuda.empty_cache()

    # 10. the stage-1 VAE training step at full width, both routes
    t0 = time.perf_counter()
    train = vae_train()
    phase_done('vae_train', t0, **train)

    # 11. kernel 4's chain at the DiT-L/2 self-attention's shapes
    t0 = time.perf_counter()
    chain = qkv_attention_chain()
    phase_done('qkv_attention_chain', t0, **chain)

    # 12. the image→3D path: a small model card vs CPU
    t0 = time.perf_counter()
    small_i23d = small_reference_i23d()
    phase_done('small_reference_i23d', t0, **small_i23d)

    # 13. the image→3D and multi-view→3D calls at full width, random
    # weights, plain and fused attention; an FM step of each denoiser;
    # the image→3D call with the int8 DiT
    image_paths = image_families()

    # 14. the ShapeNet and FFHQ paths: small models card vs CPU, then the
    # full-width calls (bf16 and int8 U-Net) and a profiled DDIM step of
    # the U-Net; then the fg/bg VAE's orbit
    t0 = time.perf_counter()
    small_unet = small_reference_unet()
    phase_done('small_reference_unet', t0, **small_unet)
    t0 = time.perf_counter()
    small_fgbg = small_reference_fgbg()
    phase_done('small_reference_fgbg', t0, **small_fgbg)
    unet_paths = unet_families()
    t0 = time.perf_counter()
    fgbg = ffhq_fgbg_render()
    phase_done('ffhq_fgbg_render', t0, **fgbg)

    # 15. the stage-2 trainer: a small DiT card vs CPU per objective, the
    # full-width DiT-L/2 step (DDPM and flow matching, remat 'dots'), the
    # EDM sampler through that DiT and the ControlNet trainer over the
    # U-Net-320
    t0 = time.perf_counter()
    small_ldm = small_ldm_train_reference()
    phase_done('small_ldm_train_reference', t0, **small_ldm)
    t0 = time.perf_counter()
    ldm, fm_model = ldm_train()
    phase_done('ldm_train', t0, **ldm)
    t0 = time.perf_counter()
    edm = edm_sample(fm_model)
    del fm_model
    torch.cuda.empty_cache()
    phase_done('edm_sample', t0, **edm)
    t0 = time.perf_counter()
    cldm = controlnet_train()
    phase_done('controlnet_train', t0, **cldm)

    # 16. the LSGM joint trainer: a small joint step card vs CPU (two
    # configs), the checkpoint round trip of its state, the full-width
    # step; the adversarial VAE trainer: a small step card vs CPU (kernels
    # 1 and 2 on the card), the full-width steps
    t0 = time.perf_counter()
    small_lsgm, small_lsgm_trainer = small_lsgm_train_reference()
    phase_done('small_lsgm_train_reference', t0, **small_lsgm)
    t0 = time.perf_counter()
    ckpt = lsgm_checkpoint(small_lsgm_trainer)
    del small_lsgm_trainer
    phase_done('lsgm_checkpoint', t0, **ckpt)
    t0 = time.perf_counter()
    lsgm = lsgm_train()
    phase_done('lsgm_train', t0, **lsgm)
    t0 = time.perf_counter()
    small_adv = small_adv_train_reference()
    phase_done('small_adv_train_reference', t0, **small_adv)
    t0 = time.perf_counter()
    adv = adv_vae_train()
    phase_done('adv_vae_train', t0, **adv)

    # 17. the EG3D warm-up (a small step card vs CPU, then its entry point
    # at full width), the 'lgm' encoder and StyleGAN3: the JAX package
    # runs no Pallas kernel on these paths, and neither does the port
    for phase, fn in (('small_eg3d_warmup_reference',
                       small_eg3d_warmup_reference),
                      ('eg3d_warmup', eg3d_warmup),
                      ('lgm_encode', lgm_encode), ('stylegan3', stylegan3)):
        t0 = time.perf_counter()
        zero_kernel_launches()
        res = fn()
        phase_done(phase, t0, **res, kernel_launches=no_kernel_launches(
            phase))

    # 18. the entry layer: the objaverse/t23d-dit release's joint
    # checkpoint under the reference's names, converted by the port's CLI
    # from .pt and .safetensors; the sample CLI on the conversion (kernel
    # 1 on the orbit and the σ grid); a legacy EG3D pickle into the
    # warm-up through its entry point (no kernel, as in JAX)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        ref_ckpt, ckpt = reference_checkpoint(workdir)
        phase_done('reference_checkpoint', t0, **ref_ckpt)
        t0 = time.perf_counter()
        entry = sample_entry(ckpt, workdir)
        del ckpt
        phase_done('sample_entry', t0, **entry)
        t0 = time.perf_counter()
        zero_kernel_launches()
        teacher = eg3d_teacher_pickle(workdir)
        phase_done('eg3d_teacher_pickle', t0, **teacher,
                   kernel_launches=no_kernel_launches('eg3d_teacher_pickle'))

    # 19. the parallel layer at a world size of 1 under NCCL: the
    # data-parallel VAE step (kernels 1 and 2) against the step without a
    # mesh, the five training CLIs, the sharded serving call (kernel 1)
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as workdir:
        init_nccl(workdir)
        try:
            t0 = time.perf_counter()
            par = parallel_vae_train()
            phase_done('parallel_vae_train', t0, **par)
            t0 = time.perf_counter()
            zero_kernel_launches()
            entries = train_entries(workdir)
            phase_done('train_entries', t0, **entries,
                       kernel_launches=kernel_launches())
            t0 = time.perf_counter()
            served = serving_mesh(prompt)
            phase_done('serving_mesh', t0, sizes=CUT, **served)
        finally:
            dist.destroy_process_group()

    # 20. the data layer: synthetic instances into tar shards through the
    # port's wds_create, the native reader against tarfile, the stream
    # through PostProcess into the full-width VAE step (kernels 1 and 2)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        data_train = data_vae_train(workdir)
        phase_done('data_vae_train', t0, **data_train)

    # 21. evaluation (the FID InceptionV3 and the evaluator CLI), the sgm
    # stacks, a profiler trace of the fused denoiser (kernel 3), the
    # two-stage demo after the training entries, and the image→3D demo's
    # command-line fallback (kernel 1)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        evaluated = evaluation(workdir)
        phase_done('evaluation', t0, **evaluated)
    t0 = time.perf_counter()
    sgm = sgm_stack()
    phase_done('sgm_stack', t0, **sgm)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        traced = profiling_trace(workdir)
        phase_done('profiling_trace', t0, **traced)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        demo = two_stage_demo(workdir)
        phase_done('two_stage_demo', t0, **demo)
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        i23d_demo = gradio_i23d(workdir)
        phase_done('gradio_i23d', t0, **i23d_demo)

    osg_main, attn_main, bwd_main = checks[0], attn_checks[0], bwd_checks[0]
    osg_ffhq = next(c for c in checks if c['case'] == 'ffhq_frame')
    osg_fgbg = next(c for c in checks if c['case'] == 'fgbg_frame')
    qkv_main = qkv_checks[0]
    attn_i23d = attn_checks[1]
    calls = {'t23d_serving': serving,
             't23d_dpm25': samplers['dpm25'],
             't23d_plms25': samplers['plms25'],
             't23d_int8_plain_attention': int8['plain_attention'],
             't23d_int8_fused_attention': int8['fused_attention']}
    for family, res in image_paths.items():
        for attn in ('plain_attention', 'fused_attention'):
            calls[f'{family}_{attn}'] = res[attn]
    calls['i23d_int8_plain_attention'] = image_paths['i23d']['int8']
    calls.update(unet_paths)
    osg_by_path = {k: sum(r['fused_osg_launches'].values())
                   for k, r in calls.items()}
    attn_by_path = {k: r['fused_attention_launches']
                    for k, r in calls.items()}
    osg_by_path['ffhq_fgbg_render'] = fgbg['kernel_1']['fused_osg_launches']
    osg_by_path['adv_vae_train'] = adv['fused_osg_launches']
    osg_by_path['sample_entry'] = entry['fused_osg_launches']['total']
    osg_by_path['parallel_vae_train'] = par['fused_osg_launches']
    osg_by_path['serving_mesh'] = served['fused_osg_launches']
    osg_by_path['data_vae_train'] = data_train['fused_osg_launches']
    osg_by_path['gradio_i23d'] = i23d_demo['per_image'][0][
        'fused_osg_launches']
    attn_by_path['profiling_trace'] = traced['fused_attention_launches']
    for key in ('cameras', 'flat_rays'):
        osg_by_path[f'orbit_{key}'] = orbit[key]['fused_osg_launches']
        attn_by_path[f'orbit_{key}'] = orbit[key]['fused_attention_launches']
    emit({'kernels': [
        dict(name='fused_osg', route='cuda',
             source='ln3diff_tpu_torch/ops/csrc/fused_osg.cu',
             replaces='ln3diff_tpu/ops/fused_render.py:98',
             launches=sum(serving['fused_osg_launches'].values()),
             launches_by_path=osg_by_path,
             max_abs_err=max(max(c['max_abs_err_rgb'],
                                 c['max_abs_err_sigma']) for c in checks),
             ms=osg_main['ms'], device_ms=osg_main['device_ms'],
             host_us=osg_main['host_us'], plain_ms=osg_main['plain_ms'],
             bound_ms=osg_main['bound_ms'], bound_by=osg_main['bound_by'],
             library_ms=None,
             at_ffhq_frame={k: osg_ffhq[k] for k in (
                 'M', 'ms', 'device_ms', 'host_us', 'plain_ms', 'bound_ms',
                 'bound_by')},
             at_fgbg_frame={k: osg_fgbg[k] for k in (
                 'M', 'ms', 'device_ms', 'host_us', 'plain_ms', 'bound_ms',
                 'bound_by')}),
        dict(name='fused_attention', route='cuda',
             source='ln3diff_tpu_torch/ops/csrc/fused_attention.cu',
             replaces='ln3diff_tpu/ops/fused_attention.py:39',
             launches=serving['fused_attention_launches'],
             launches_by_path=attn_by_path,
             max_abs_err=max(c['max_abs_err'] for c in attn_checks),
             ms=attn_main['ms'], device_ms=attn_main['device_ms'],
             plain_ms=attn_main['plain_ms'],
             bound_ms=attn_main['bound_ms'], bound_by=attn_main['bound_by'],
             library_ms=attn_main['library_ms'],
             at_i23d_shape={k: attn_i23d[k] for k in (
                 'shape', 'ms', 'device_ms', 'host_us', 'plain_ms',
                 'bound_ms', 'bound_by', 'library_ms',
                 'library_device_ms')}),
        dict(name='fused_osg_bwd', route='cuda',
             source='ln3diff_tpu_torch/ops/csrc/fused_osg_bwd.cu',
             replaces='ln3diff_tpu/ops/fused_render.py:219',
             launches=train['fused']['fused_osg_backward_launches'],
             launches_by_path={
                 'vae_train': train['fused']['fused_osg_backward_launches'],
                 'adv_vae_train': adv['fused_osg_backward_launches'],
                 'parallel_vae_train': par['fused_osg_backward_launches'],
                 'data_vae_train': data_train['fused_osg_backward_launches']},
             max_abs_err=max(e for c in bwd_checks
                             for e in c['max_abs_err'].values()),
             ms=bwd_main['ms'], device_ms=bwd_main['device_ms'],
             host_us=bwd_main['host_us'], plain_ms=bwd_main['plain_ms'],
             bound_ms=bwd_main['bound_ms'], bound_by=bwd_main['bound_by'],
             library_ms=None),
        dict(name='fused_qkv_attention', route='cuda',
             source='ln3diff_tpu_torch/ops/csrc/fused_qkv_attention.cu',
             replaces='ln3diff_tpu/ops/fused_attention.py:104',
             launches=chain['fused_qkv_attention_launches'],
             max_abs_err=max(c['max_abs_err'] for c in qkv_checks),
             ms=qkv_main['ms'], device_ms=qkv_main['device_ms'],
             plain_ms=qkv_main['plain_ms'],
             bound_ms=qkv_main['bound_ms'], bound_by=qkv_main['bound_by'],
             library_ms=qkv_main['library_ms'])]})
    print(smi_line, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
