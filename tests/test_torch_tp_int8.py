"""Tensor-parallel serving of int8 layers and convs
(``ln3diff_tpu_torch/parallel/serving.py``, ``ops/int8.py``) on 2 and 4
gloo ranks, against the whole layer and the whole denoiser, and the
placement rules of the int8 denoisers against JAX's.

* Each split layer equals the whole layer **bit for bit**: ``Int8Linear``
  column (the output gathered), row with a whole input (the rank's
  columns of the whole row's int8 values), row paired after a column
  layer (the per-token amax MAX-reduced), the 1x1 ``Int8Conv`` the same
  three ways, and the float 1x1 conv column and row on integer-valued
  data (every f32 product and sum exact).  On random f32 data the float
  conv's row partials sum in another order: within 1e-6 of scale.
* Every layer whose kernel ``tensor_parallel_rules`` places on 'tensor'
  is replaced by its split module and holds 1/tp of the kernel: the toy
  DiT (its int8 blocks and float embedders) and the toy U-Net with the
  spatial transformer (1x1 ``proj_in``/``proj_out``, the GEGLU) or the
  ADM attention (1x1 ``qkv``/``proj`` on the rank's heads), float and
  int8.  A layer of a type with no split module under the rules raises.
* The int8 GEMM's width check refuses a shard whose widths are not
  multiples of 8 on a CUDA device, naming the layer; the released widths
  (DiT-L/2 and the U-Net-320, int8) split cleanly at tp = 2, 4 and 8.
* DDIM sampling with CFG through the split denoiser against the whole
  one: the int8 DiT within 1e-2 of scale (the int8 bound of rounding
  flips: its float embedders split too, and a summation order an ulp
  away can flip an activation at an int8 rounding midpoint; measured
  4.0e-4 of a scale of 1043 at tp = 4, not bit for bit), the f32 U-Net
  within 2e-4 of scale (as ``tests/test_torch_serving_parallel.py``
  holds the DiT; measured 2.7e-6 of 2.3), and its int8 twin within 1e-2
  of scale (measured bit for bit: every split of the int8 U-Net is an
  int8 layer).
* The port's tensor rules on the int8 toy DiT and U-Net, ``kernel_q``
  included, against JAX's ``PartitionSpec``s through the bridge, as
  ``tests/test_torch_parallel.py`` holds the float ones.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from ln3diff_tpu.models import dit as jdit
from ln3diff_tpu.models import unet as junet
from ln3diff_tpu.parallel import mesh as jmesh
from ln3diff_tpu_torch import bridge
from ln3diff_tpu_torch.config import denoiser_preset
from ln3diff_tpu_torch.models import dit as tdit
from ln3diff_tpu_torch.models import unet as tunet
from ln3diff_tpu_torch.ops.int8 import (Int8Linear, Int8Module,
                                        _quantize_rows, check_int8_shard,
                                        column_shard, int8_dense,
                                        int8_dense_acc,
                                        int8_dense_row_partial,
                                        int8_rescale, row_shard)
from ln3diff_tpu_torch.parallel import mesh as tmesh
from ln3diff_tpu_torch.parallel.serving import SPLIT_CLASSES

import _torch_parallel_tasks as tasks
from _torch_ranks import RankPool
from test_torch_parallel import DIT, UNET, _jax_mesh, _Sizes, _varying_dim

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

WORLDS = [2, 4]
TOL_F32 = 2e-4
TOL_INT8 = 1e-2


@pytest.fixture(scope='module')
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = RankPool(world, tmp_path_factory.mktemp(
                f'ranks{world}'))
        return made[world]
    yield get
    for p in made.values():
        p.close()


@pytest.fixture(scope='module')
def layer_results(pools):
    return {w: pools(w).run(tasks.tp_int8_layers) for w in WORLDS}


INT8_CASES = ['int8_linear_column', 'int8_linear_row', 'int8_linear_paired',
              'int8_conv_column', 'int8_conv_row', 'int8_conv_paired',
              'float_conv_column_exact', 'float_conv_row_exact']


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', INT8_CASES)
def test_split_layer_equals_whole_bit_for_bit(layer_results, world, case):
    for o in layer_results[world]:
        r = o[case]
        np.testing.assert_array_equal(r['got'], r['want'])
        assert all(k.startswith(('ColumnParallel', 'RowParallel'))
                   for k in r['kinds']), r['kinds']
    kinds = layer_results[world][0][case]['kinds']
    if case.endswith('paired'):
        assert kinds[0].startswith('Column') and kinds[1].startswith('Row')


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('case', ['float_conv_column', 'float_conv_row'])
def test_split_float_conv_on_random_data(layer_results, world, case):
    for o in layer_results[world]:
        r = o[case]
        scale = max(1.0, float(np.abs(r['want']).max()))
        np.testing.assert_allclose(r['got'], r['want'], rtol=0,
                                   atol=1e-6 * scale)


def test_rank_local_pieces_sum_to_the_whole_layer():
    """The pure pieces of ``ops/int8.py`` for each rank r in one process:
    column shards are the whole output's slices, and the int32 row
    partials sum to the whole accumulator, bit for bit."""
    g = torch.Generator().manual_seed(3)
    layer = tasks._int8_layer(Int8Linear, 64, 48, g)
    x = torch.randn(3, 7, 64, generator=g)
    want = layer(x)
    x_q = _quantize_rows(x)[0]
    for tp in (2, 4):
        cols_out = []
        parts = []
        for r in range(tp):
            rows = torch.arange(r * 48 // tp, (r + 1) * 48 // tp)
            cols_out.append(int8_dense(x, *column_shard(layer, rows)))
            cols = torch.arange(r * 64 // tp, (r + 1) * 64 // tp)
            acc, x_scale = int8_dense_row_partial(x, row_shard(layer, cols),
                                                  cols=cols)
            parts.append(acc)
        assert torch.equal(torch.cat(cols_out, -1), want)
        total = torch.stack(parts).sum(0, dtype=torch.int32)
        assert torch.equal(total, int8_dense_acc(x_q, layer.kernel_q))
        assert torch.equal(int8_rescale(total, x_scale, layer.scale,
                                        layer.bias, x.dtype), want)


PLACEMENTS = [('dit', True, True), ('dit', False, True),
              ('unet', False, True), ('unet', True, True),
              ('unet', False, False), ('unet', True, False)]


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('which,quantized,spatial', PLACEMENTS)
def test_every_sharded_layer_is_split(pools, world, which, quantized,
                                      spatial):
    outs = pools(world).run(tasks.tp_placement, which, quantized, spatial)
    split = outs[0]
    names = {c.__name__ for c in SPLIT_CLASSES}
    assert split
    for owner, o in split.items():
        assert o['kind'] in names, (owner, o)
        assert o['local'] * world == o['whole'], (owner, o)
    if quantized:
        assert any('Int8' in o['kind'] for o in split.values())
    if which == 'unet':
        markers = ('proj_in', 'proj_out') if spatial else ('qkv', 'proj')
        for m in markers:
            hit = [o['kind'] for k, o in split.items()
                   if k.split('.')[-1] == m]
            assert hit and all(('Int8Conv' if quantized else 'Conv2d')
                               in k for k in hit), (m, hit)


@pytest.mark.parametrize('world', WORLDS)
def test_unsplittable_layer_under_the_rules_raises(pools, world):
    for o in pools(world).run(tasks.tp_refuses_unsplittable):
        assert 'no split module' in o and 'Conv1d' in o, o


def test_int8_shard_width_check():
    with pytest.raises(ValueError, match='mid_attn.proj_in'):
        check_int8_shard('mid_attn.proj_in', 24, 12, 'cuda')
    with pytest.raises(ValueError, match='blocks.3.mlp.fc2'):
        check_int8_shard('blocks.3.mlp.fc2', 4 * 1020 // 8, 1024, 'cuda')
    check_int8_shard('mid_attn.proj_in', 24, 12, 'cpu')
    check_int8_shard('blocks.3.attn.qkv', 1024, 3072 // 4, 'cuda')


@pytest.mark.parametrize('tp', [2, 4, 8])
@pytest.mark.parametrize('which', ['t23d-dit-l2', 'shapenet-unet'])
def test_released_widths_split_cleanly(which, tp):
    """Every int8 kernel that the rules shard at the released widths
    (DiT-L/2: 1024/3072/4096; the U-Net-320's transformer at 1280
    channels) gives shards that the CUDA int8 GEMM takes."""
    import dataclasses
    cls = tdit.DiT_TriLatent if which.startswith('t23d') \
        else tunet.UNetModel
    with torch.device('meta'):
        model = cls(dataclasses.replace(denoiser_preset(which),
                                        quantized=True))
    rules = tmesh.tensor_parallel_rules(model, _Sizes(tensor=tp))
    t_i = tmesh.AXES.index('tensor')
    mods = dict(model.named_modules())
    checked = 0
    for name, pl in rules.items():
        owner, _, leaf = name.rpartition('.')
        if leaf != 'kernel_q' or not pl[t_i].is_shard():
            continue
        kq = mods[owner].kernel_q
        k2 = kq[0, 0].numel()
        fan_out, fan_in = kq.shape[:2]
        if pl[t_i].dim == 0:
            check_int8_shard(owner, fan_in * k2, fan_out // tp, 'cuda')
        else:
            check_int8_shard(owner, fan_in // tp * k2, fan_out, 'cuda')
        checked += 1
    assert checked >= (4 * 24 if which.startswith('t23d') else 4 * 6)


@pytest.mark.parametrize('world', WORLDS)
def test_tp_sampling_int8_dit(pools, world):
    outs = pools(world).run(tasks.tp_sampling, 0, which='dit',
                            quantized=True)
    o = outs[0]
    scale = max(1.0, float(np.abs(o['ref']).max()))
    err = float(np.abs(o['got'] - o['ref']).max())
    assert err <= TOL_INT8 * scale, (err, scale)
    assert o['heads'] == 4 // world
    assert o['kinds']['attn.qkv'] == 'ColumnParallelInt8Linear'
    assert o['kinds']['attn.proj'] == 'RowParallelInt8Linear'
    assert o['kinds']['mlp.fc2'] == 'RowParallelInt8Linear'
    for other in outs[1:]:
        np.testing.assert_array_equal(other['got'], o['got'])


@pytest.mark.parametrize('world', WORLDS)
@pytest.mark.parametrize('quantized', [False, True])
@pytest.mark.parametrize('spatial', [True, False])
def test_tp_sampling_unet(pools, world, quantized, spatial):
    outs = pools(world).run(tasks.tp_sampling, 0, which='unet',
                            quantized=quantized, spatial=spatial)
    o = outs[0]
    scale = max(1.0, float(np.abs(o['ref']).max()))
    err = float(np.abs(o['got'] - o['ref']).max())
    assert err <= (TOL_INT8 if quantized else TOL_F32) * scale, (err, scale)
    assert o['kinds'], 'nothing was split'
    for other in outs[1:]:
        np.testing.assert_array_equal(other['got'], o['got'])


# -- the rules on the int8 denoisers against JAX's ---------------------------

def _marked(params, shardings, axis):
    """Each leaf as a ramp along the JAX dim that ``axis`` shards (zeros
    where it shards none); the ramp stays within int8 (1..100, repeating),
    as ``kernel_q`` goes through the bridge as int8."""
    def mark(p, s):
        spec = tuple(s.spec) + (None,) * (p.ndim - len(s.spec))
        out = np.zeros(p.shape, np.float32)
        for d, names in enumerate(spec):
            names = names if isinstance(names, tuple) else (names,)
            if axis in names:
                shape = [1] * p.ndim
                shape[d] = p.shape[d]
                out = out + (np.arange(p.shape[d]) % 100 + 1).astype(
                    np.float32).reshape(shape)
        return out
    return jax.tree_util.tree_map(
        mark, params, shardings,
        is_leaf=lambda x: isinstance(x, NamedSharding))


@pytest.mark.parametrize('which', ['dit', 'unet'])
def test_int8_tensor_rules_match_jax(which):
    if which == 'dit':
        jm = jdit.DiT_TriLatent(jdit.DiTConfig(dtype=jnp.float32,
                                               quantized=True, **DIT))
        args = (jnp.ones((8, 8, 8, 12)), jnp.ones((8,)),
                {'crossattn': jnp.ones((8, 7, 32))})
        module = tdit.DiT_TriLatent(tdit.DiTConfig(
            dtype=torch.float32, quantized=True, **DIT))
        to_port = bridge.dit_state_dict
    else:
        jm = junet.UNetModel(junet.UNetConfig(dtype=jnp.float32,
                                              quantized=True, **UNET))
        args = (jnp.zeros((2, 8, 8, 12)), jnp.zeros((2,)),
                jnp.zeros((2, 7, 16)))
        module = tunet.UNetModel(tunet.UNetConfig(
            dtype=torch.float32, quantized=True, **UNET))
        to_port = bridge.unet_state_dict
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args)['params']
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    shapes)
    sizes = dict(data=2, tensor=2)
    jspec = jmesh.tensor_parallel_rules(params, _jax_mesh(**sizes), 256)
    tpl = tmesh.tensor_parallel_rules(module, _Sizes(**sizes), 256)
    marks = to_port(_marked(params, jspec, 'tensor'))
    t_i = tmesh.AXES.index('tensor')
    int8_sharded = 0
    for k, pl in tpl.items():
        got = _varying_dim(marks[k].float())
        if got is None:
            assert pl[t_i].is_replicate(), (k, pl)
        else:
            assert pl[t_i].is_shard() and pl[t_i].dim == got, (k, pl, got)
            int8_sharded += k.endswith('kernel_q')
    assert int8_sharded > 0
    kq = {n for n, _ in module.named_buffers() if n.endswith('kernel_q')}
    assert kq <= set(tpl)
    assert all(isinstance(m, Int8Module) for n, m in module.named_modules()
               if f'{n}.kernel_q' in kq)
