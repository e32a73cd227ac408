"""The port's GPipe schedule (``ln3diff_tpu_torch/parallel/pipeline.py``)
against the JAX package, on four gloo ranks.

``dit_pipeline_apply`` of a toy DiT (depth 4) at (pp, n_micro) = (2, 4),
(4, 4) and (2, 2) — pp·dp = 4 ranks — and at pp = 1 with four
microbatches (``_pipeline_pp1``), with remat, and with the PixArt
variant's shared adaLN: the output against JAX's plain apply (and JAX's
own ``dit_pipeline_apply`` on a (2, 2) device mesh) within 1e-5
absolute, as JAX's tests hold its schedule; the grads of ``Σ out · c``
(a fixed random cotangent) within 1e-5 of each grad's scale, with a
floor of 1e-6 of the largest grad (grads that are zero in exact
arithmetic, the attention's key bias, hold f32 noise on both sides).
Each stage holds grads for its own blocks only.  Then one flow-matching
``LDMTrainer`` step on a (2, 2, 1, 1) mesh against the plain (4, 1, 1, 1)
one from the same weights and draws: loss within rtol 1e-5, every
parameter within 1e-5 of its scale plus 1e-2·lr, and each rank's train
state holding its stage's blocks only.  Last, that trainer's state saved
by ``CheckpointManager`` (rank 0 writes the state gathered over the
stages, or over the FSDP shards on a (2, 1, 2, 1) mesh) and restored
into a trainer drawn from another seed: every held tensor and module
parameter equal, and the saved parameters equal to the step's.  Then the
same across layouts: a checkpoint written under (2, 1, 2, 1) with the
FSDP-sharded module, or under (1, 2, 1, 1) on two ranks, restored into a
one-device trainer and written back for the meshed one, every leaf equal
at each hop.  Under pp = 2 the other stage's blocks are on the ``meta``
device of each rank.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.parallel import pipeline as jpipe
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.parallel import pipeline as tpipe

import _torch_parallel_tasks as tasks
from _torch_ranks import RankPool

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
           depth=4, num_heads=2, context_dim=32)
TOL = 1e-5
LR = 1e-3


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp('ranks'))
    yield p
    p.close()


@pytest.fixture(scope='module')
def pool2(tmp_path_factory):
    p = RankPool(2, tmp_path_factory.mktemp('ranks2'))
    yield p
    p.close()


_CACHE = {}


def _setup(variant='text'):
    """JAX's toy DiT (perturbed params), its inputs, a cotangent, and the
    plain apply's output and grads."""
    if variant in _CACHE:
        return _CACHE[variant]
    cfg = jdit.DiTConfig(dtype=jnp.float32, variant=variant, **DIT)
    model = jdit.DiT_TriLatent(cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 12)).astype(np.float32)
    t = np.arange(4.0, dtype=np.float32) * 100
    ctx = rng.standard_normal((4, 7, 32)).astype(np.float32)
    variables = jax.jit(model.init)(jax.random.PRNGKey(2), x, t,
                                    {'crossattn': ctx})
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32)), variables['params'])
    variables = dict(variables, params=params)
    cot = rng.standard_normal((4, 8, 8, 12)).astype(np.float32)

    def loss(p):
        out = model.apply(dict(variables, params=p), x, t,
                          {'crossattn': ctx})
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    sd = {k: v.numpy() for k, v in bridge.dit_state_dict(params).items()}
    _CACHE[variant] = dict(
        model=model, variables=variables, x=x, t=t, ctx=ctx, cot=cot,
        out=np.asarray(out), sd=sd,
        grads={k: v.numpy() for k, v in bridge.dit_state_dict(
            jax.tree_util.tree_map(np.asarray, grads)).items()})
    return _CACHE[variant]


def _check(outs, want, pp):
    gmax = max(float(np.abs(g).max()) for g in want['grads'].values())
    seen = set()
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o['out'], want['out'], rtol=0, atol=TOL)
        stage = (r % pp) if pp > 1 else 0
        depth = DIT['depth']
        for k, g in o['grads'].items():
            if k.startswith('blocks.'):
                assert int(k.split('.')[1]) // (depth // pp) == stage, k
            w = want['grads'][k]
            bound = max(TOL * float(np.abs(w).max()), 1e-6 * gmax)
            np.testing.assert_allclose(g, w, rtol=0, atol=bound, err_msg=k)
            seen.add(k)
    # the caption embedder's y_embedding gets no grad in the port (zero in
    # JAX)
    zero = {k for k, g in want['grads'].items() if not np.abs(g).max()}
    assert seen | zero == set(want['grads'])


@pytest.mark.parametrize('pp,n_micro,data', [(2, 4, 2), (4, 4, 1),
                                             (2, 2, 2), (1, 4, 4)])
def test_pipeline_matches_plain_apply(pool, pp, n_micro, data):
    w = _setup()
    outs = pool.run(tasks.pipeline_forward_grads, dict(DIT, variant='text'),
                    w['sd'], w['x'], w['t'], w['ctx'], w['cot'],
                    dict(data=data, pipe=pp), n_micro)
    _check(outs, w, pp)


def test_pipeline_matches_jax_pipeline(pool):
    """Against JAX's own GPipe schedule on a (data 2, pipe 2) mesh."""
    w = _setup()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ('dp', 'pipe'))
    out = jpipe.dit_pipeline_apply(w['model'], w['variables'], w['x'],
                                   w['t'], {'crossattn': w['ctx']},
                                   mesh=mesh, n_micro=4)
    outs = pool.run(tasks.pipeline_forward_grads, dict(DIT, variant='text'),
                    w['sd'], w['x'], w['t'], w['ctx'], w['cot'],
                    dict(data=2, pipe=2), 4)
    for o in outs:
        np.testing.assert_allclose(o['out'], np.asarray(out), rtol=0,
                                   atol=TOL)


@pytest.mark.parametrize('variant,remat', [('text', True),
                                           ('pixelart-text', False)])
def test_pipeline_remat_and_pixart(pool, variant, remat):
    w = _setup(variant)
    outs = pool.run(tasks.pipeline_forward_grads, dict(DIT, variant=variant),
                    w['sd'], w['x'], w['t'], w['ctx'], w['cot'],
                    dict(data=2, pipe=2), 2, remat)
    _check(outs, w, 2)


def test_split_stages():
    stages = tpipe.split_stages(list(range(8)), 4)
    assert stages == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match='divisible'):
        tpipe.split_stages(list(range(6)), 4)


def test_ldm_trainer_pp_step_matches_plain(pool):
    w = _setup()
    rng = np.random.default_rng(5)
    batch = {'latent': rng.standard_normal((8, 8, 8, 12)).astype(np.float32),
             'context': {'crossattn': rng.standard_normal(
                 (8, 7, 32)).astype(np.float32)}}
    draws = (rng.uniform(0.05, 0.95, (8,)).astype(np.float32),
             rng.standard_normal((8, 8, 8, 12)).astype(np.float32))
    cfg = dict(DIT, variant='text')
    plain = pool.run(tasks.ldm_step, cfg, w['sd'], batch, draws,
                     dict(data=4), 2)
    piped = pool.run(tasks.ldm_step, cfg, w['sd'], batch, draws,
                     dict(data=2, pipe=2), 2)
    ref = plain[0]
    for r, o in enumerate(piped):
        np.testing.assert_allclose(o['loss'], ref['loss'], rtol=TOL)
        np.testing.assert_allclose(o['grad_norm'], ref['grad_norm'],
                                   rtol=1e-4)
        for k, v in ref['params'].items():
            scale = max(float(np.abs(v).max()), 1e-30)
            np.testing.assert_allclose(o['params'][k], v, rtol=0,
                                       atol=TOL * scale + 1e-2 * LR,
                                       err_msg=k)
        stage = r % 2
        held = [k for k in o['held'] if k.startswith('blocks.')]
        assert held and all(int(k.split('.')[1]) // 2 == stage
                            for k in held)
        # the other stage's blocks left the device (meta)
        assert o['on_device'] == [2 * stage, 2 * stage + 1]
    assert all(o['on_device'] == [0, 1, 2, 3] for o in plain)


@pytest.mark.parametrize('mesh_kw,fsdp', [(dict(data=2, pipe=2), False),
                                          (dict(data=2, fsdp=2), True)])
def test_checkpoint_roundtrip_across_ranks(pool, tmp_path, mesh_kw, fsdp):
    w = _setup()
    rng = np.random.default_rng(6)
    batch = {'latent': rng.standard_normal((8, 8, 8, 12)).astype(np.float32),
             'context': {'crossattn': rng.standard_normal(
                 (8, 7, 32)).astype(np.float32)}}
    draws = (rng.uniform(0.05, 0.95, (8,)).astype(np.float32),
             rng.standard_normal((8, 8, 8, 12)).astype(np.float32))
    outs = pool.run(tasks.checkpoint_roundtrip, str(tmp_path),
                    dict(DIT, variant='text'), w['sd'], batch, draws,
                    mesh_kw, fsdp)
    plain = pool.run(tasks.ldm_step, dict(DIT, variant='text'), w['sd'],
                     batch, draws, dict(data=4), 2)[0]
    for o in outs:
        assert o['held'] and o['moments'] and o['ema'] and o['modules']
        assert o['step'] == 1 and o['count'] == 1
        assert (o['sharded'] > 0) == fsdp and (o['absent'] > 0) == (not fsdp)
    for k, v in plain['params'].items():
        scale = max(float(np.abs(v).max()), 1e-30)
        np.testing.assert_allclose(outs[0]['saved'][k], v, rtol=0,
                                   atol=TOL * scale + 1e-2 * LR, err_msg=k)


@pytest.mark.parametrize('layout', ['data2_fsdp2', 'pipe2'])
def test_checkpoint_across_layouts(request, tmp_path, layout):
    """A checkpoint written under (2, 1, 2, 1) (state and module sharded
    by the FSDP rules) or (1, 2, 1, 1) (each stage holding its blocks)
    restores into a one-device trainer, which writes it again for the
    meshed layout to restore: every leaf (params, EMA, moments, counts)
    equal at each hop, and each module holding the restored tensors."""
    mesh_kw, fsdp, pool = {
        'data2_fsdp2': (dict(data=2, fsdp=2), True, 'pool'),
        'pipe2': (dict(data=1, pipe=2), False, 'pool2')}[layout]
    pool = request.getfixturevalue(pool)
    w = _setup()
    rng = np.random.default_rng(7)
    batch = {'latent': rng.standard_normal((4, 8, 8, 12)).astype(np.float32),
             'context': {'crossattn': rng.standard_normal(
                 (4, 7, 32)).astype(np.float32)}}
    draws = (rng.uniform(0.05, 0.95, (4,)).astype(np.float32),
             rng.standard_normal((4, 8, 8, 12)).astype(np.float32))
    cfg = dict(DIT, variant='text')
    meshed, one_dev, back = (str(tmp_path / d) for d in ('a', 'b', 'c'))
    saved = pool.run(tasks.checkpoint_layout, meshed, cfg, w['sd'], batch,
                     draws, mesh_kw, fsdp)
    one = tasks.checkpoint_layout(one_dev, cfg, None, None, None, {}, False,
                                  restore_from=meshed)
    again = pool.run(tasks.checkpoint_layout, None, cfg, None, None, None,
                     mesh_kw, fsdp, restore_from=one_dev)

    def equal(a, b):
        assert sorted(a) == sorted(b)
        for part in ('params', 'ema', 'mu', 'nu'):
            assert sorted(a[part]) == sorted(b[part])
            for k in a[part]:
                np.testing.assert_array_equal(a[part][k], b[part][k],
                                              err_msg=f'{part}.{k}')
        assert a['count'] == b['count'] == 1 and a['step'] == b['step'] == 1

    assert saved[0]['sharded'] == fsdp and (saved[0]['absent'] > 0) != fsdp
    assert not one['sharded'] and one['absent'] == 0
    for o in saved + [one] + again:
        assert o['module_is_state']
    for o in saved[1:] + [one] + again:
        equal(saved[0], o)
