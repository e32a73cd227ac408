"""The port's parallel layer (``ln3diff_tpu_torch/parallel/mesh.py``) and
the meshed train step (``training/train_state.py``) against the JAX
package and against one rank.

* The placement rules: for a toy DiT and a toy U-Net, every port
  parameter's placements are held against JAX's ``PartitionSpec`` of the
  leaf it comes from.  Each sharded JAX dim is marked (an arange along
  it), the marked tree goes through ``bridge.dit_state_dict`` /
  ``unet_state_dict``, and the port tensor must vary along exactly the
  dim its placement shards (``Shard(d)``); a ``'pipe'`` stacked axis
  becomes the block index (``LayerShard``).  Exact.
* One ``build_train_step`` step of the MSE loss of JAX's
  ``tests/test_parallel.py`` on four gloo ranks, meshes (4,1,1,1) — also
  with two microbatches and with a scalar batch leaf — (2,1,2,1) under
  ``param_sharding_rules`` and (2,1,1,2) under ``tensor_parallel_rules``,
  against JAX's step on one device from the same weights: loss within
  1e-5 relative, every parameter after the AdamW step within 1e-5 of its
  scale plus 1e-2·lr (AdamW normalises a grad that is zero in exact
  arithmetic — the attention's key bias — and holds f32 noise into a step
  of up to lr, as the trainer tests allow), every rank equal, and each
  sharded parameter, AdamW moment and EMA holding 1/2 of its elements on a
  rank.  Under the FSDP rules the module holds each sharded parameter as
  its half (``parallel/fsdp.py``): the bytes a rank holds, counted over
  the distinct storages of the module's parameters, the grads the
  optimizer gets, the moments and the EMA, are each sharded parameter's
  once per kind at 1/2 and each replicated one's whole; a forward
  pre-hook on every module sees at most one unit (a trunk block, or the
  root) with whole parameters alive, and none is alive after the step.
  Under the tensor rules the module and its grads stay whole (the tensor
  ranks compute as data replicas) and the slice each rank updates, its
  moments and EMA are halves.
* The batch helpers, the mesh's sizes and ``host_rng``.

The gloo ranks (``tests/_torch_ranks.py``) run the port only; JAX runs
here.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.parallel import mesh as jmesh
from ln3diff_tpu.training import train_state as jts
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.parallel import mesh as tmesh

import _torch_parallel_tasks as tasks
from _torch_ranks import RankPool

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

DIT = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
           depth=2, num_heads=2, variant='text', context_dim=32)
UNET = dict(in_channels=4, model_channels=8, out_channels=4,
            num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
            num_heads=2, use_spatial_transformer=True, context_dim=16,
            roll_out=True)
LR = 1e-3
TOL = 1e-5


@pytest.fixture(scope='module')
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp('ranks'))
    yield p
    p.close()


class _Sizes:
    """A stand-in mesh for the rules: they read the axis sizes only."""

    def __init__(self, data=1, pipe=1, fsdp=1, tensor=1):
        self.shape = (data, pipe, fsdp, tensor)


def _jax_mesh(data=1, pipe=1, fsdp=1, tensor=1):
    n = data * pipe * fsdp * tensor
    return jmesh.make_mesh(jmesh.MeshConfig(data=data, fsdp=fsdp,
                                            tensor=tensor, pipe=pipe),
                           devices=jax.devices()[:n])


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            p.shape).astype(np.float32), params)


_INIT = {}


def _dit_params():
    if 'dit' not in _INIT:
        model = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32, **DIT))
        variables = jax.jit(model.init)(
            jax.random.PRNGKey(0), jnp.ones((8, 8, 8, 12)), jnp.ones((8,)),
            {'crossattn': jnp.ones((8, 7, 32))})
        _INIT['dit'] = (model, _perturbed(variables['params'], 1),
                        {k: v for k, v in variables.items()
                         if k != 'params'})
    return _INIT['dit']


def _unet_params():
    model = junet.UNetModel(junet.UNetConfig(dtype=jnp.float32, **UNET))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 8, 8, 12)), jnp.zeros((2,)),
                            jnp.zeros((2, 7, 16)))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                  shapes['params'])


# -- (a) placements -----------------------------------------------------------

def _marked(params, shardings, axis):
    """Each leaf as an arange along the JAX dim that ``axis`` shards
    (zeros where it shards none)."""
    def mark(p, s):
        spec = tuple(s.spec) + (None,) * (p.ndim - len(s.spec))
        out = np.zeros(p.shape, np.float32)
        for d, names in enumerate(spec):
            names = names if isinstance(names, tuple) else (names,)
            if axis in names:
                shape = [1] * p.ndim
                shape[d] = p.shape[d]
                out = out + np.arange(1, p.shape[d] + 1, dtype=np.float32
                                      ).reshape(shape)
        return out
    return jax.tree_util.tree_map(
        mark, params, shardings,
        is_leaf=lambda x: isinstance(x, NamedSharding))


def _varying_dim(t: torch.Tensor):
    """The one dim along which ``t`` varies, None if constant."""
    dims = [d for d in range(t.ndim)
            if t.shape[d] > 1 and not torch.equal(
                t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) <= 1, dims
    return dims[0] if dims else None


CASES = {
    # (model, mesh sizes, rules, min size)
    'dit_fsdp': ('dit', dict(data=2, fsdp=2), 'fsdp', 1024),
    'dit_tensor': ('dit', dict(data=2, tensor=2), 'tensor', 256),
    'dit_fsdp_tensor': ('dit', dict(fsdp=2, tensor=2), 'tensor', 256),
    'dit_pipe': ('dit', dict(data=2, pipe=2), 'pipe', 0),
    'unet_tensor': ('unet', dict(data=2, tensor=2), 'tensor', 256),
    'unet_fsdp': ('unet', dict(data=2, fsdp=2), 'fsdp', 1024),
}


@pytest.mark.parametrize('case', list(CASES))
def test_placements_match_jax_specs(case):
    which, sizes, rules, min_size = CASES[case]
    if which == 'dit':
        params = _dit_params()[1]
        module = tdit.DiT_TriLatent(tdit.DiTConfig(dtype=torch.float32,
                                                   **DIT))
        to_port = bridge.dit_state_dict
    else:
        params = _unet_params()
        module = tunet.UNetModel(tunet.UNetConfig(dtype=torch.float32,
                                                  **UNET))
        to_port = bridge.unet_state_dict
    mesh = _jax_mesh(**sizes)
    if rules == 'fsdp':
        jspec = jmesh.param_sharding_rules(params, mesh, min_size)
        tpl = tmesh.param_sharding_rules(module, _Sizes(**sizes), min_size)
    elif rules == 'tensor':
        jspec = jmesh.tensor_parallel_rules(params, mesh, min_size)
        tpl = tmesh.tensor_parallel_rules(module, _Sizes(**sizes), min_size)
    else:
        jspec = jmesh.pipeline_parallel_rules(params, mesh)
        tpl = tmesh.pipeline_parallel_rules(module, _Sizes(**sizes))
    names = {k for k, _ in module.named_parameters()}
    assert sorted(tpl) == sorted(names)
    sharded = 0
    for axis in ('fsdp', 'tensor', 'pipe'):
        i = tmesh.AXES.index(axis)
        marks = to_port(_marked(params, jspec, axis))
        for k in names:
            pl = tpl[k][i]
            got = _varying_dim(marks[k])
            if axis == 'pipe':
                hit = tmesh.trunk_index(k)
                stacked = hit is not None and float(marks[k].flatten()[0]) \
                    == hit[1] + 1
                assert (pl == tmesh.LayerShard()) == stacked, (k, pl)
                sharded += stacked
                continue
            if got is None:
                assert pl.is_replicate(), (axis, k, pl)
            else:
                assert pl.is_shard() and pl.dim == got, (axis, k, pl, got)
                sharded += 1
    assert sharded > 0
    if rules == 'tensor':
        t_i = tmesh.AXES.index('tensor')
        split = [k for k in names if tpl[k][t_i].is_shard()]
        marker = 'qkv' if which == 'dit' else 'ff_proj'
        assert any(marker in k.split('.') for k in split), split


# -- (b) the meshed step --------------------------------------------------------

def _jax_step(batch, microbatch_steps=1):
    model, params, consts = _dit_params()
    mesh = _jax_mesh()

    def loss_fn(p, c, b, rng):
        x = b['x']
        out = model.apply({'params': p, **(c or {})}, x,
                          jnp.ones((x.shape[0],)), {'crossattn': b['ctx']})
        loss = jnp.mean((out - x)**2)
        if 'step' in b:
            loss = loss * (b['step'] * 0 + 1)
        return loss, {'mse': loss}

    state = jts.create_train_state(jax.tree_util.tree_map(jnp.asarray,
                                                          params),
                                   jts.make_optimizer(LR),
                                   ema_rates=(('ema', 0.5),),
                                   constants=consts)
    step = jts.build_train_step(loss_fn, mesh, ema_rates=(('ema', 0.5),),
                                microbatch_steps=microbatch_steps,
                                donate=False)
    with mesh:
        state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray,
                                                            batch),
                              jax.random.PRNGKey(0))
    return float(metrics['loss']), bridge.dit_state_dict(
        jax.tree_util.tree_map(np.asarray, state.params))


def _batch(lead=(8,)):
    rng = np.random.default_rng(3)
    return {'x': rng.standard_normal(lead + (8, 8, 12)).astype(np.float32),
            'ctx': rng.standard_normal(lead + (7, 32)).astype(np.float32)}


STEPS = {
    'data4': (dict(data=4), None, 0, 1, False),
    'data4_microbatch2': (dict(data=4), None, 0, 2, False),
    'data2_fsdp2_scalar_leaf': (dict(data=2, fsdp=2), 'fsdp', 1024, 1,
                                True),
    'data2_tensor2': (dict(data=2, tensor=2), 'tensor', 256, 1, False),
}


@pytest.mark.parametrize('case', list(STEPS))
def test_train_step_matches_jax(pool, case):
    mesh_kw, rules, min_size, micro, scalar = STEPS[case]
    batch = _batch() if micro == 1 else _batch((micro, 8))
    if scalar:
        batch['step'] = np.float32(7.0)
    want_loss, want = _jax_step(batch, micro)
    sd = {k: v.numpy() for k, v in bridge.dit_state_dict(
        _dit_params()[1]).items()}
    out = pool.run(tasks.dit_train_step, DIT, sd, batch, mesh_kw, rules,
                   min_size, LR, micro)
    for r in out:
        assert abs(r['loss'] - want_loss) <= TOL * abs(want_loss)
        if scalar:
            assert r['step'] == 7.0
        for k, w in want.items():
            w = w.numpy()
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(r['params'][k], w, rtol=0,
                                       atol=TOL * scale + 1e-2 * LR,
                                       err_msg=k)
            np.testing.assert_array_equal(r['params'][k],
                                          out[0]['params'][k])
    sizes = out[0]['sizes']
    assert bool(sizes) == (rules is not None)
    in_module = rules == 'fsdp'
    sharded = 0
    for k, s in sizes.items():
        local, whole = s['param']
        assert 2 * local == whole, k
        assert s['mu'] == s['nu'] == s['ema'] == (local,), k
        for r in out:
            assert r['numels'][k] == (local if in_module else whole), k
        sharded += 4 * whole      # f32 bytes
    rest = 4 * sum(n for k, n in out[0]['numels'].items() if k not in sizes)
    for r in out:
        if in_module:
            # module param (the DTensor's storage), grad, mu, nu, EMA
            assert r['module_bytes'] == rest + sharded // 2
            assert r['held_bytes'] == 5 * rest + 5 * sharded // 2
            assert r['units_whole'] == 1 and r['units_whole_after'] == 0
        else:
            # the module and its grads whole; the slice, mu, nu, EMA
            assert r['module_bytes'] == rest + sharded
            assert r['held_bytes'] == (5 * rest + 2 * sharded
                                       + 4 * sharded // 2)


def test_sharded_module_outside_the_step(pool):
    """A module sharded by the FSDP rules over (1, 1, 4, 1) runs outside a
    training step as its unsharded twin: the same output under
    ``no_grad``, the same input grad through ``frozen_apply`` and no
    parameter grad; ``load_module`` writes each rank's shard of whole
    tensors; a module is sharded once."""
    out = pool.run(tasks.fsdp_module_checks, dict(data=1, fsdp=4))
    for o in out:
        assert o['sharded'] == ['0.weight', '2.weight']
        assert o['shapes']['0.weight'] in ((16, 64), (64, 16))
        assert o['shapes']['0.bias'] == (64,)
        assert o['same_out'] and o['loaded'] and o['no_param_grads']
        assert o['grads_in'] <= 1e-6
        assert 'already sharded' in o['twice']


# -- batch helpers, sizes, host RNG ---------------------------------------------

def test_batch_slices_and_gathers(pool):
    out = pool.run(tasks.batch_roundtrip)
    for r, o in enumerate(out):
        # (data, fsdp) = (2, 2): dp index = rank
        np.testing.assert_array_equal(o['local'], np.arange(16).reshape(
            8, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o['micro_local'][:, 0],
                                      [r, 4 + r])
        assert o['step'] == 7.0
        np.testing.assert_array_equal(o['gathered'],
                                      np.arange(16).reshape(8, 2))
        assert o['coord'] == [r // 2, 0, r % 2, 0]
        np.testing.assert_array_equal(
            o['host_draw'], np.random.default_rng([5, r]).integers(0, 99, 4))
    with pytest.raises(RuntimeError, match='divisible'):
        pool.run(tasks.batch_roundtrip, 6)


def test_mesh_without_a_process_group():
    mesh = tmesh.make_mesh()
    assert isinstance(mesh, tmesh.LocalMesh)
    assert tmesh.axis_size(mesh, 'data', 'fsdp') == 1
    assert tmesh.axis_index(mesh, 'data') == 0
    tree = {'a': torch.arange(4), 's': 2.0}
    assert tmesh.data_sharding(mesh, tree) is tree
    assert tmesh.replicated(mesh, tree) is tree
    with pytest.raises(ValueError, match='ranks'):
        tmesh.make_mesh(tmesh.MeshConfig(fsdp=2))
    assert tmesh.host_shard() == (0, 1)
    np.testing.assert_array_equal(tmesh.host_rng(3).random(3),
                                  np.random.default_rng([3, 0]).random(3))
    assert tmesh.initialize_distributed('cpu') is False
