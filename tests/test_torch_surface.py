"""The port's surface against the JAX package's, read from the sources
with ``ast``: no module of either package is imported.

For each module ``ln3diff_tpu/<path>.py`` the port must have
``ln3diff_tpu_torch/<path>.py``, defining every public top-level name of
the JAX module (functions, classes, assignments, and a package's lazy
``_EXPORTS``) and, for every dataclass of the JAX module, every field (as
a field of the port's dataclass, or an argument of its class's
``__init__`` where the port's is a plain class).
What the port leaves out stands in the allow-lists below, each entry with
the JAX ``file:line`` (checked against the source) and the reason:

* ``'unread'``: a config field that nothing in its JAX module reads (the
  test checks that no attribute of that name is loaded there);
* ``'unused'``: a name that no other code of the JAX package refers to
  (checked likewise);
* ``'renamed'``: the port has it under another name (checked to exist);
* ``'replaced'`` and ``'jax_only'``: the port does the same otherwise, or
  it is machinery of XLA, Pallas or optax that has no PyTorch
  counterpart; the reason says which.

Every entry must still be missing from the port: one that the port has
gained fails the test until it is taken off the list.  A field on the
lists is ``'unread'``, but for the Pallas kernel's interpret switch: the
port lacks no config field that the JAX package reads.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, 'ln3diff_tpu')
PORT_PKG = os.path.join(ROOT, 'ln3diff_tpu_torch')

MISSING_MODULES = {
    'utils/cache.py': ('jax_only', "XLA's persistent compilation cache; "
                       'eager PyTorch compiles nothing, and ops/_build.py '
                       'caches the built kernels'),
}

# (JAX module, name) → (line, kind, reason or the port's name)
MISSING_NAMES = {
    ('ops/fused_render.py', 'TILE'): (
        50, 'jax_only', "the Pallas kernel's grid tile; the CUDA kernel "
        '(ops/csrc/fused_osg.cu) sizes its own blocks'),
    ('ops/int8.py', 'Int8Dense'): (84, 'renamed', 'Int8Linear'),
    ('evaluation/inception.py', 'InceptionConfig'): (
        212, 'replaced', 'num_classes is an argument of InceptionV3; the '
        'network runs in f32, the dtype in which JAX\'s evaluator builds it '
        '(evaluation/metrics.py:209)'),
    ('evaluation/inception.py', 'convert_inception_state_dict'): (
        296, 'replaced', "the port's InceptionV3 carries pytorch-fid's "
        'parameter names, so a pytorch-fid state dict loads as it is'),
    ('training/eg3d_warmup.py', 'optax_global_norm'): (
        281, 'renamed', 'training/train_state.py:global_norm'),
    ('training/train_state.py', 'create_train_state'): (
        54, 'renamed', 'TrainState.create'),
    ('training/vision_aided.py', 'make_head_optimizer'): (
        168, 'replaced', 'an optax.multi_transform over one tree; the port '
        'keeps the frozen backbone out of the optimizer (requires_grad '
        'False) and builds make_optimizer over the heads'),
    ('parallel/serving.py', 'shard_map'): (
        30, 'jax_only', 'the alias of jax.shard_map; the port runs each '
        "rank's share under torch.distributed"),
    ('models/layers.py', 'MLP'): (70, 'unused', 'DiT blocks build their own'),
    ('models/layers.py', 'modulate'): (83, 'unused', 't2i_modulate is used'),
    ('native/build.py', 'build_and_load'): (
        24, 'replaced', 'ops/_build.py builds every native source'),
    ('native/build.py', 'get_mesh_io'): (
        103, 'replaced', 'render/mesh.py loads the mesh library (_marcher)'),
    ('native/build.py', 'get_marching_tetrahedra'): (
        121, 'replaced', 'render/mesh.py loads the mesh library (_marcher)'),
    ('native/build.py', 'get_marching_tetrahedra_cells'): (
        136, 'replaced', 'render/mesh.py loads the mesh library (_marcher)'),
}

# (JAX module, 'Class.field') → (line, kind, reason)
MISSING_FIELDS = {
    ('ops/fused_render.py', 'FusedOSG.interpret'): (
        473, 'jax_only', "Pallas's interpret mode; the port's wrapper runs "
        'the plain version on a CPU tensor'),
    ('conditioning/clip.py', 'CLIPVisionConfig.projection_dim'): (
        52, 'unread', 'the towers return no projected embedding'),
    ('training/gan.py', 'GANConfig.disc_start_step'): (
        33, 'unread', 'the discriminator starts at step 0'),
    ('training/gan.py', 'GANConfig.adaptive_weight'): (
        34, 'unread', 'the weight is calculate_adaptive_weight, called '
        'directly'),
    ('training/ldm_trainer.py', 'LDMTrainConfig.total_steps'): (
        53, 'unread', 'the CLIs pass the step count to train_until'),
    ('training/vae_trainer.py', 'VAETrainConfig.batch_instances'): (
        44, 'unread', 'the batch size is the loader\'s'),
    ('training/vae_trainer.py', 'VAETrainConfig.save_interval'): (
        66, 'unread', 'the CLIs pass it to train_until'),
    ('render/renderer.py', 'RenderOptions.unify_bf16'): (
        57, 'unread', 'the planes\' dtype is the caller\'s render_dtype'),
    ('models/vae_shapenet.py', 'ShapeNetVAEConfig.bg_depth_resolution'): (
        68, 'unread', 'the ShapeNet VAE has no background pass'),
    ('models/vae_shapenet.py', 'ShapeNetVAEConfig.lrm_decoder'): (
        69, 'unread', 'the ShapeNet VAE builds the OSG decoder'),
    ('models/vae_shapenet.py', 'FFHQVAEConfig.bg_depth_resolution'): (
        226, 'unread', 'the FFHQ VAE has no background pass'),
    ('models/vae_shapenet.py', 'FFHQVAEConfig.lrm_decoder'): (
        227, 'unread', 'the FFHQ VAE builds the OSG decoder'),
}

KINDS = {'unread', 'unused', 'renamed', 'replaced', 'jax_only'}


def _modules(pkg):
    out = {}
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(root, f)
                out[os.path.relpath(path, pkg).replace(os.sep, '/')] = path
    return out


def _parse(path):
    with open(path, encoding='utf-8') as f:
        return ast.parse(f.read(), filename=path)


def _is_dataclass(node):
    return any('dataclass' in ast.unparse(d) for d in node.decorator_list)


def surface(tree):
    """(public top-level name → line, class name → {field → line}, class
    name → {member names}); a dataclass's fields are its annotated
    attributes, another class's its ``__init__`` arguments."""
    names, fields, members = {}, {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names[node.name] = node.lineno
        if isinstance(node, ast.ClassDef):
            members[node.name] = {
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            if _is_dataclass(node):
                fields[node.name] = {
                    n.target.id: n.lineno for n in node.body
                    if isinstance(n, ast.AnnAssign)
                    and isinstance(n.target, ast.Name)}
            else:
                fields[node.name] = {
                    a.arg: n.lineno for n in node.body
                    if isinstance(n, ast.FunctionDef)
                    and n.name == '__init__'
                    for a in n.args.args[1:] + n.args.kwonlyargs}
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            if not isinstance(t, ast.Name):
                continue
            names[t.id] = node.lineno
            if t.id == '_EXPORTS' and isinstance(node.value, ast.Dict):
                for k in node.value.keys:
                    names[ast.literal_eval(k)] = node.lineno
    return ({k: v for k, v in names.items() if not k.startswith('_')},
            fields, members)


JAX_MODULES = _modules(JAX_PKG)
PORT_MODULES = _modules(PORT_PKG)
JAX_TREES = {rel: _parse(path) for rel, path in JAX_MODULES.items()}
PORT_SURFACES = {rel: surface(_parse(path))
                 for rel, path in PORT_MODULES.items()}


def _loaded_attributes(tree):
    return {n.attr for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load)}


def _referenced_names(tree):
    refs = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            refs.add(n.id)
        elif isinstance(n, ast.Attribute):
            refs.add(n.attr)
        elif isinstance(n, ast.ImportFrom):
            refs.update(a.name for a in n.names)
    return refs


@pytest.mark.parametrize('rel', sorted(JAX_MODULES))
def test_port_module_has_the_jax_surface(rel):
    """The module's counterpart, its public names and its dataclasses'
    fields, less the entries of the allow-lists."""
    if rel in MISSING_MODULES:
        assert rel not in PORT_MODULES, f'{rel} is ported: drop its entry'
        return
    assert rel in PORT_MODULES, f'ln3diff_tpu_torch/{rel} is missing'
    jnames, jclasses, _ = surface(JAX_TREES[rel])
    jfields = {c: f for c, f in jclasses.items()
               if _is_dataclass(_class(JAX_TREES[rel], c))}
    tnames, tfields, _ = PORT_SURFACES[rel]
    missing = {n for n in jnames if n not in tnames}
    listed = {n for (r, n) in MISSING_NAMES if r == rel}
    assert missing == listed, (
        f'{rel}: not in the port and not listed: {sorted(missing - listed)}; '
        f'listed but in the port: {sorted(listed - missing)}')
    missing = set()
    for cls, fs in jfields.items():
        if cls in missing_classes(rel):
            continue
        assert cls in tfields, f'{rel}: {cls} is not a class in the port'
        missing |= {f'{cls}.{f}' for f in fs if f not in tfields[cls]}
    listed = {n for (r, n) in MISSING_FIELDS if r == rel}
    assert missing == listed, (
        f'{rel}: fields not in the port and not listed: '
        f'{sorted(missing - listed)}; listed but in the port: '
        f'{sorted(listed - missing)}')


def _class(tree, name):
    return next(n for n in tree.body
                if isinstance(n, ast.ClassDef) and n.name == name)


def missing_classes(rel):
    return {n for (r, n) in MISSING_NAMES if r == rel}


@pytest.mark.parametrize('key', sorted(MISSING_NAMES), ids='::'.join)
def test_missing_name_entry(key):
    """The entry's line is the JAX definition's; an ``'unused'`` name is
    referred to nowhere else in the JAX package; a ``'renamed'`` one
    exists in the port under its new name."""
    rel, name = key
    line, kind, reason = MISSING_NAMES[key]
    assert kind in KINDS - {'unread'} and reason
    assert surface(JAX_TREES[rel])[0].get(name) == line, key
    if kind == 'unused':
        for other, tree in JAX_TREES.items():
            assert name not in _referenced_names(tree), (
                f'{name} is used in {other}')
    if kind == 'renamed':
        where, _, new = reason.rpartition(':')
        names, _, members = PORT_SURFACES[where or rel]
        cls, _, member = new.partition('.')
        assert cls in names, f'{new} is not in the port'
        if member:
            assert member in members[cls], f'{new} is not in the port'


@pytest.mark.parametrize('key', sorted(MISSING_FIELDS), ids='::'.join)
def test_missing_field_entry_is_unread(key):
    """The entry's line is the JAX field's, and an ``'unread'`` field's
    module loads no attribute of that name."""
    rel, qual = key
    line, kind, reason = MISSING_FIELDS[key]
    assert reason and (kind == 'unread' or qual == 'FusedOSG.interpret')
    cls, field = qual.split('.')
    assert surface(JAX_TREES[rel])[1][cls].get(field) == line, key
    if kind == 'unread':
        assert field not in _loaded_attributes(JAX_TREES[rel]), (
            f'{rel} reads .{field}')
