#!/usr/bin/env python3
"""The port's parallel layer on several CUDA cards under NCCL.

    torchrun --nproc_per_node=4 scripts/parallel_card_check.py
    torchrun --nproc_per_node=4 scripts/parallel_card_check.py --device cpu
    torchrun --nproc_per_node=4 scripts/parallel_card_check.py --only tp_

Each rank runs the multi-rank tasks of the CPU tests
(``tests/_torch_parallel_tasks.py``) on its card, and the same work
without a mesh as the one-rank reference, and checks the two agree:

* ``build_train_step`` on meshes (4,1,1,1), (2,1,2,1) under
  ``param_sharding_rules`` and (2,1,1,2) under ``tensor_parallel_rules``
  (a toy DiT, f32): loss within 1e-5 relative, every parameter within
  1e-5 of its scale plus 1e-2·lr, each sharded tensor 1/2 of its bytes
  (under the FSDP rules the module's own parameter too, and at most one
  unit's parameters whole at a time);
* ``dit_pipeline_apply`` at (pp, n_micro) = (2, 4) on (2, 2, 1, 1) and
  (4, 4) on (1, 4, 1, 1): the output within 1e-5 absolute, each stage's
  grads within 1e-5 of scale (floor 1e-6 of the largest) — the schedule's
  point-to-point sends carry no tags under NCCL, so this checks their
  order; the pipelined ``LDMTrainer`` step's loss within 1e-5 relative;
* the sharded text→3D call (kernel 1) over four data ranks against the
  unsharded one: latents and σ grid equal, frames within 1e-6; tensor-
  parallel DDIM sampling over four ranks within 2e-4 of scale;
* the preemption guard's agreement (SIGTERM to rank 1) and a checkpoint
  round trip of FSDP-sharded and pipeline-staged train states;
* on the cards only, the full-width DiT-L/2 LDM step (remat 'dots', bf16
  autocast, global batch 8) at fsdp = 1 and at fsdp = 4: each rank's
  resident and peak memory (the parameters sharded in the module at
  fsdp = 4) and s/step, the first losses within 1e-2 relative;
* on the cards only, tensor-parallel DDIM over four ranks against the
  whole denoiser on each rank: the int8 DiT-L/2 with fused attention
  (kernel 3 at 16 / 4 = 4 heads, 24 launches a step) within 1e-2 of
  scale or twice the whole DiT's move under a one-bf16-ulp change of
  its condition (its float embedders split in bf16), its first call
  likewise, and the ShapeNet U-Net-320 (int8 ``proj_in``/``proj_out`` and
  GEGLU split in int8, the float ones in float) in f32 within 2e-4 of
  scale and int8 within 1e-2 — the CPU tests' bounds
  (``tests/test_torch_tp_int8.py``) — and in bf16, whose row partials
  round to bf16 before the all-reduce (2^-8 relative), within 1e-2.

Prints one JSON line per check on rank 0, the card's name and power limit,
and ``{"ok": ...}`` last; exits non-zero if any check failed.  It needs
the repository's ``tests/`` beside ``scripts/`` and four ranks: four
cards, or with ``--device cpu`` four gloo processes (no kernel).
"""

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..'))
sys.path.insert(0, os.path.join(HERE, '..', 'tests'))

DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
           depth=4, num_heads=2, variant='text', context_dim=32)
LR, TOL = 1e-3, 1e-5


def _close_params(got, want, lr=LR):
    worst = 0.0
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        worst = max(worst, err / (TOL * scale + 1e-2 * lr))
    return worst


def main():
    import torch
    import torch.distributed as dist
    from ln3diff_tpu_torch.models.dit import DiT_TriLatent, DiTConfig
    from ln3diff_tpu_torch.models.layers import random_init_
    import _torch_parallel_tasks as tasks

    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    parser.add_argument('--only', nargs='*', default=None,
                        help='run only the checks whose names start with '
                             'one of these prefixes')
    cli = parser.parse_args()
    dev = cli.device
    if 'WORLD_SIZE' not in os.environ:
        print('parallel_card_check: run under torchrun', file=sys.stderr)
        return 1
    if dev == 'cuda' and not torch.cuda.is_available():
        print('parallel_card_check: no CUDA device', file=sys.stderr)
        return 1
    if dev == 'cuda':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    # a rank that fails inside a collective fails the others in minutes
    dist.init_process_group('nccl' if dev == 'cuda' else 'gloo',
                            timeout=datetime.timedelta(seconds=180))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = dist.get_rank(), dist.get_world_size()
    if world != 4:
        print('parallel_card_check: needs 4 ranks', file=sys.stderr)
        return 1
    if dev == 'cuda':
        from ln3diff_tpu_torch.ops._build import build_all
        if rank == 0:
            build_all()
        dist.barrier()
        if rank:
            build_all()

    model = DiT_TriLatent(DiTConfig(**DIT, dtype=torch.float32))
    random_init_(model, torch.Generator().manual_seed(0))
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(3)
    batch = {'x': rng.standard_normal((8, 8, 8, 12)).astype(np.float32),
             'ctx': rng.standard_normal((8, 7, 32)).astype(np.float32)}
    failed = []

    def report(name, ok, t0, **fields):
        flag = torch.tensor([int(bool(ok))], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        if not flag.item():
            failed.append(name)
        if rank == 0:
            print(json.dumps({'check': name, 'ok': bool(flag.item()),
                              'seconds': round(time.perf_counter() - t0, 3),
                              **fields}, default=float), flush=True)

    def run(name, fn):
        if cli.only is not None and not name.startswith(tuple(cli.only)):
            return
        t0 = time.perf_counter()
        try:
            fn(name, t0)
        except Exception:
            traceback.print_exc()
            report(name, False, t0, error='exception (stderr)')

    def train_step(name, t0, mesh_kw, rules, min_size):
        got = tasks.dit_train_step(DIT, sd, batch, mesh_kw, rules, min_size,
                                   LR, device=dev)
        want = tasks.dit_train_step(DIT, sd, batch, None, device=dev)
        loss_rel = abs(got['loss'] - want['loss']) / abs(want['loss'])
        worst = _close_params(got['params'], want['params'])
        halves = all(2 * s['param'][0] == s['param'][1]
                     for s in got['sizes'].values())
        in_module = all(got['numels'][k] == (s['param'][0] if rules == 'fsdp'
                                             else s['param'][1])
                        for k, s in got['sizes'].items())
        units = (got['units_whole'], got['units_whole_after'])
        report(name, loss_rel <= TOL and worst <= 1 and halves and in_module
               and bool(got['sizes']) == (rules is not None)
               and (units == (1, 0) or rules != 'fsdp'), t0,
               loss_rel=loss_rel, params_worst_share_of_tol=worst,
               sharded=len(got['sizes']), module_bytes=got['module_bytes'],
               held_bytes=got['held_bytes'],
               units_whole_during_and_after=units)

    for name, mesh_kw, rules, size in (
            ('train_step_data4', dict(data=4), None, 0),
            ('train_step_data2_fsdp2', dict(data=2, fsdp=2), 'fsdp', 1024),
            ('train_step_data2_tensor2', dict(data=2, tensor=2), 'tensor',
             256)):
        run(name, lambda n, t0, m=mesh_kw, r=rules, s=size:
            train_step(n, t0, m, r, s))

    prng = np.random.default_rng(0)
    x = prng.standard_normal((4, 8, 8, 12)).astype(np.float32)
    t = np.arange(4.0, dtype=np.float32) * 100
    ctx = prng.standard_normal((4, 7, 32)).astype(np.float32)
    cot = prng.standard_normal((4, 8, 8, 12)).astype(np.float32)

    def pipeline(name, t0, mesh_kw, n_micro):
        got = tasks.pipeline_forward_grads(DIT, sd, x, t, ctx, cot, mesh_kw,
                                           n_micro, device=dev)
        want = tasks.pipeline_forward_grads(DIT, sd, x, t, ctx, cot, None,
                                            1, device=dev)
        out_err = float(np.abs(got['out'] - want['out']).max())
        gmax = max(float(np.abs(g).max()) for g in want['grads'].values())
        worst = 0.0
        for k, g in got['grads'].items():
            w = want['grads'][k]
            bound = max(TOL * float(np.abs(w).max()), 1e-6 * gmax)
            worst = max(worst, float(np.abs(g - w).max()) / bound)
        report(name, out_err <= TOL and worst <= 1, t0,
               out_max_abs_err=out_err, grads_worst_share_of_tol=worst,
               grads=len(got['grads']))

    run('gpipe_pp2_micro4', lambda n, t0: pipeline(
        n, t0, dict(data=2, pipe=2), 4))
    run('gpipe_pp4_micro4', lambda n, t0: pipeline(
        n, t0, dict(data=1, pipe=4), 4))

    lrng = np.random.default_rng(5)
    lbatch = {'latent': lrng.standard_normal((8, 8, 8, 12)).astype(
                  np.float32),
              'context': {'crossattn': lrng.standard_normal(
                  (8, 7, 32)).astype(np.float32)}}
    draws = (lrng.uniform(0.05, 0.95, (8,)).astype(np.float32),
             lrng.standard_normal((8, 8, 8, 12)).astype(np.float32))

    def ldm_pp(name, t0):
        got = tasks.ldm_step(DIT, sd, lbatch, draws, dict(data=2, pipe=2), 2,
                             device=dev)
        want = tasks.ldm_step(DIT, sd, lbatch, draws, None, 2, device=dev)
        loss_rel = abs(got['loss'] - want['loss']) / abs(want['loss'])
        worst = _close_params(got['params'], want['params'])
        report(name, loss_rel <= TOL and worst <= 1, t0, loss_rel=loss_rel,
               params_worst_share_of_tol=worst)

    run('ldm_trainer_pp2', ldm_pp)

    def serving(name, t0, flat):
        with tempfile.TemporaryDirectory() as d:
            o = tasks.serving_call(d, 8, 32, flat, device=dev)
        s, p = o['sharded'], o['plain']
        frames = float(np.abs(s['video'] - p['video']).max())
        ok = (np.array_equal(s['latents'], p['latents'])
              and np.array_equal(s['sigma'], p['sigma'])
              and frames <= 1e-6)
        report(name, ok, t0, frames_max_abs_err=frames)

    run('serving_mesh_data4', lambda n, t0: serving(n, t0, False))
    run('serving_mesh_data4_flat_rays', lambda n, t0: serving(n, t0, True))

    def tp(name, t0, min_size):
        o = tasks.tp_sampling(min_size, device=dev)
        scale = max(1.0, float(np.abs(o['ref']).max()))
        err = float(np.abs(o['got'] - o['ref']).max())
        report(name, err <= 2e-4 * scale, t0, max_abs_err=err,
               split_layers=len(o['kinds']), heads=o['heads'])

    run('tp_sampling_tensor4', lambda n, t0: tp(n, t0, 0))

    def guard(name, t0):
        o = tasks.preempt_loop(1, 5)
        report(name, o['stopped'] == 6 and o['preempted'], t0,
               stopped_after=o['stopped'])

    run('preemption_guard', guard)

    def ckpt(name, t0, mesh_kw, fsdp):
        d = tempfile.mkdtemp() if rank == 0 else None
        box = [d]
        dist.broadcast_object_list(box, src=0)
        o = tasks.checkpoint_roundtrip(box[0], DIT, sd, lbatch, draws,
                                       mesh_kw, fsdp, device=dev)
        report(name, o['held'] and o['moments'] and o['ema']
               and o['modules'] and o['step'] == 1, t0,
               sharded=o['sharded'], absent=o['absent'])

    run('checkpoint_fsdp', lambda n, t0: ckpt(n, t0, dict(data=2, fsdp=2),
                                              True))
    run('checkpoint_pipe', lambda n, t0: ckpt(n, t0, dict(data=2, pipe=2),
                                              False))

    def ldm_memory(name, t0):
        """The full-width DiT-L/2 LDM step (the t23d preset, remat 'dots',
        bf16 autocast, flow matching, global batch 8) at fsdp = 1 (data 4)
        and at fsdp = 4: per-rank resident and peak memory, s/step."""
        import dataclasses

        from ln3diff_tpu_torch.config import denoiser_preset
        from ln3diff_tpu_torch.parallel import mesh as pmesh
        from ln3diff_tpu_torch.training.ldm_trainer import (LDMDraws,
                                                            LDMTrainConfig,
                                                            LDMTrainer)
        cfg = dataclasses.replace(denoiser_preset('t23d-dit-l2'), remat=True,
                                  remat_policy='dots')
        g = torch.Generator().manual_seed(0)
        lat = torch.randn((8, 32, 32, 12), generator=g).cuda()
        ctx = torch.randn((8, 77, 768), generator=g).cuda()
        out = {}
        for label, mesh_kw in (('fsdp1', dict(data=4)),
                               ('fsdp4', dict(data=1, fsdp=4))):
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mesh = pmesh.make_mesh(pmesh.MeshConfig(**mesh_kw))
            with torch.device('cuda'):
                dit = DiT_TriLatent(cfg)
            tr = LDMTrainer(dit, LDMTrainConfig(objective='flow_matching',
                                                lr=1e-4, log_interval=10**9),
                            seed=0, device='cuda', mesh=mesh)
            random_init_(tr.model, torch.Generator(
                device='cuda').manual_seed(0))
            tr.build()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated() - base
            losses, secs = [], []
            for i in range(3):
                gd = torch.Generator().manual_seed(10 + i)
                draws = LDMDraws(torch.rand((8,), generator=gd).cuda(),
                                 torch.randn(lat.shape, generator=gd).cuda())
                torch.cuda.synchronize()
                s0 = time.perf_counter()
                m = tr.train_step({'latent': lat,
                                   'context': {'crossattn': ctx}}, draws)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - s0)
                losses.append(float(m['loss']))
            out[label] = dict(
                resident_gib=round(resident / 2**30, 3),
                peak_gib=round((torch.cuda.max_memory_allocated() - base)
                               / 2**30, 3),
                s_per_step=sum(secs[1:]) / 2, losses=losses,
                sharded=len(tr.state.sharded.dims)
                if tr.state.sharded is not None else 0,
                params=sum(p.numel() for p in tr.state.params.values()))
            del tr, dit
        first_rel = abs(out['fsdp4']['losses'][0] - out['fsdp1']['losses'][0]
                        ) / abs(out['fsdp1']['losses'][0])
        report(name, all(np.isfinite(v['losses']).all()
                         for v in out.values())
               and out['fsdp4']['resident_gib'] < out['fsdp1']['resident_gib']
               and first_rel <= 1e-2, t0, first_loss_rel=first_rel,
               per_rank=out)

    if dev == 'cuda':
        run('ldm_dit_l2_memory_fsdp1_vs_fsdp4', ldm_memory)

    def tp_dit_l2_int8(name, t0):
        """The split int8 DiT-L/2's latents within 1e-2 of scale of the
        whole one's, or within twice the whole one's own move under a
        one-bf16-ulp change of its condition (``twin``): its float
        embedders split in bf16, where a row shard's partial sums round
        to bf16 before the all-reduce, and CFG 6.5 carries an int8
        rounding flip on through the steps.  The first call's output
        split against whole likewise, against the first call's twin."""
        o = tasks.tp_sampling_dit_l2_int8()
        scale = max(1.0, float(np.abs(o['ref']).max()))
        err = float(np.abs(o['got'] - o['ref']).max())
        twin = float(np.abs(o['twin'] - o['ref']).max())
        c_scale = max(1.0, float(np.abs(o['call_ref']).max()))
        c_err = float(np.abs(o['call_got'] - o['call_ref']).max())
        c_twin = float(np.abs(o['call_twin'] - o['call_ref']).max())
        want_launches = o['depth'] * 10
        report(name, err <= max(1e-2 * scale, 2 * twin)
               and c_err <= max(1e-2 * c_scale, 2 * c_twin)
               and o['heads'] == 4
               and o['fused_attention_launches'] == want_launches, t0,
               max_abs_err=err, scale=scale, twin_max_abs_err=twin,
               bit_for_bit=err == 0.0, first_call_max_abs_err=c_err,
               first_call_scale=c_scale, first_call_twin_max_abs_err=c_twin,
               heads=o['heads'],
               fused_attention_launches=o['fused_attention_launches'])

    def tp_unet(name, t0, kind, tol):
        o = tasks.tp_sampling_shapenet_unet(kind)
        scale = max(1.0, float(np.abs(o['ref']).max()))
        err = float(np.abs(o['got'] - o['ref']).max())
        report(name, err <= tol * scale and np.isfinite(o['got']).all(),
               t0, max_abs_err=err, scale=scale, tol=tol,
               bit_for_bit=err == 0.0)

    if dev == 'cuda':
        run('tp_ddim_int8_dit_l2_fused_tensor4', tp_dit_l2_int8)
        for kind, tol in (('float32', 2e-4), ('bfloat16', 1e-2),
                          ('int8', 1e-2)):
            run(f'tp_ddim_shapenet_unet_{kind}_tensor4',
                lambda n, t0, k=kind, tl=tol: tp_unet(n, t0, k, tl))

    if rank == 0:
        kind = 'cpu'
        if dev == 'cuda':
            smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                                  '--format=csv,noheader'],
                                 capture_output=True, text=True,
                                 timeout=60).stdout.strip()
            print(smi.splitlines()[0] if smi else '', flush=True)
            kind = torch.cuda.get_device_name(0)
        print(json.dumps({'ok': not failed, 'failed': failed,
                          'world_size': world, 'kind': kind}), flush=True)
    dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
