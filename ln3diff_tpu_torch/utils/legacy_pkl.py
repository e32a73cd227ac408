"""Bounded extractor for StyleGAN legacy "persistence" pickles.

Port of ``ln3diff_tpu/utils/legacy_pkl.py`` (``load_stubbed``,
``flatten_state_dict``, ``describe``, ``legacy_pkl_to_npz``).  The
reference saves EG3D / StyleGAN2 checkpoints through
``utils/torch_utils/persistence.py:37``: every decorated module pickles
as ``(_reconstruct_persistent_obj, (meta,), None)`` where ``meta`` is
``dict(type='class', version, module_src=<whole module source text>,
class_name, state=<the nn.Module __dict__>)`` (``persistence.py:120-132``),
and loading (``legacy.py:368``) EXECUTES ``module_src`` to rebuild the
class.  Nothing is executed here: a stub ``Unpickler`` captures ``meta``
verbatim, torch's own tensors and storages deserialize through torch, and
the captured ``state`` trees are walked (``_parameters`` / ``_buffers`` /
``_modules``) into a flat ``{dotted_name: np.ndarray}`` state dict — the
names ``torch.nn.Module.state_dict()`` would give, which the converters of
``conditioning/convert_ln3diff.py`` key on (``convert_eg3d_generator``
for the EG3D warm-up teacher).  A bf16 tensor becomes f32 numpy.
"""

from __future__ import annotations

import io
import pickle
from typing import Any

import numpy as np


class _StubBase:
    """Inert stand-in for any non-torch class in the pickle: accepts any
    construction protocol, records state, executes nothing."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.__dict__['_stub_args'] = args
        obj.__dict__['_stub_kwargs'] = kwargs
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__['_stub_state'] = state


class _EasyDictStub(dict):
    """dnnlib.EasyDict: a dict with attribute access."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value


class PersistentObj:
    """Captured ``_reconstruct_persistent_obj`` payload."""

    def __init__(self, meta):
        self.meta = dict(meta)

    @property
    def class_name(self) -> str:
        return self.meta.get('class_name', '?')

    @property
    def state(self) -> dict:
        return dict(self.meta.get('state') or {})


def _reconstruct_capture(meta):
    return PersistentObj(meta)


# Exact (module, name) pairs the REAL import path is allowed for — the
# specific reconstruction callables torch/numpy tensor deserialization
# needs, nothing else.  A prefix allowlist (the first cut of this file)
# admitted all of ``builtins`` — i.e. ``exec``/``eval`` via a REDUCE
# opcode — which would defeat the module's no-code-execution guarantee
# for untrusted pickles.
_ALLOWED_GLOBALS = {
    ('collections', 'OrderedDict'),
    ('_codecs', 'encode'),
    ('torch._utils', '_rebuild_tensor'),
    ('torch._utils', '_rebuild_tensor_v2'),
    ('torch._utils', '_rebuild_parameter'),
    ('numpy', 'ndarray'),
    ('numpy', 'dtype'),
    ('numpy.core.multiarray', '_reconstruct'),
    ('numpy.core.multiarray', 'scalar'),
    ('numpy._core.multiarray', '_reconstruct'),
    ('numpy._core.multiarray', 'scalar'),
}
# torch module attributes: storage classes (FloatStorage, ...), dtype
# singletons (torch.float32, ...), Size/device — data holders only.
_TORCH_DTYPES = frozenset(
    f'{base}{bits}' for base in ('int', 'uint') for bits in
    (8, 16, 32, 64)) | {
    'float16', 'float32', 'float64', 'bfloat16', 'bool',
    'complex64', 'complex128'}


def _torch_attr_allowed(name: str) -> bool:
    return name.endswith('Storage') or name in _TORCH_DTYPES \
        or name in ('Size', 'device')


def _safe_load_from_bytes(b):
    """Restricted stand-in for ``torch.storage._load_from_bytes``.

    The real function (torch 2.x) is ``torch.load(io.BytesIO(b),
    weights_only=False)`` — a fully unrestricted NESTED unpickle of
    attacker-controlled bytes, i.e. a well-known RCE gadget that would
    defeat this module's no-code-execution guarantee if allowlisted
    directly (a REDUCE through it reaches arbitrary callables).  Legacy
    torch-saved storages deserialize fine under ``weights_only=True``;
    anything else (a smuggled inner pickle) raises instead of executing."""
    import torch
    return torch.load(io.BytesIO(b), weights_only=True)


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if name == '_reconstruct_persistent_obj':
            return _reconstruct_capture
        if name == 'EasyDict':
            return _EasyDictStub
        if (module, name) == ('torch.storage', '_load_from_bytes'):
            return _safe_load_from_bytes
        if (module, name) in _ALLOWED_GLOBALS or \
                (module == 'torch' and _torch_attr_allowed(name)):
            # real torch tensor/storage reconstruction + data types
            return super().find_class(module, name)
        return type(name, (_StubBase,), {'__module__': module})


def load_stubbed(path_or_file) -> Any:
    """Unpickle a legacy file with stubbed classes (no code execution
    beyond torch's own tensor deserialization)."""
    if hasattr(path_or_file, 'read'):
        return _StubUnpickler(path_or_file).load()
    with open(path_or_file, 'rb') as f:
        return _StubUnpickler(f).load()


def _to_numpy(t) -> np.ndarray:
    from ..conditioning.convert import _np
    return _np(t)


def _module_state(obj):
    """The ``__dict__`` of a captured torch module, whether it arrived as
    a PersistentObj (decorated classes) or a real torch module / stub."""
    if isinstance(obj, PersistentObj):
        return obj.state
    d = getattr(obj, '__dict__', None)
    return d if isinstance(d, dict) else None


def flatten_state_dict(obj, prefix: str = '') -> dict[str, np.ndarray]:
    """Walk ``_parameters`` / ``_buffers`` / ``_modules`` recursively into
    a flat dotted-name → numpy dict (identical naming to
    ``nn.Module.state_dict()``, which the converters key on)."""
    out: dict[str, np.ndarray] = {}
    state = _module_state(obj)
    if state is None:
        return out
    for bag in ('_parameters', '_buffers'):
        for k, v in (state.get(bag) or {}).items():
            if v is not None:
                out[prefix + k] = _to_numpy(v)
    for k, sub in (state.get('_modules') or {}).items():
        if sub is not None:
            out.update(flatten_state_dict(sub, prefix + k + '.'))
    return out


def describe(obj) -> dict:
    """Init metadata of a captured persistent object (class name +
    construction args — the reference's ``init_args``/``init_kwargs``
    feature), for reconstructing the matching config."""
    state = _module_state(obj) or {}

    def plain(x):
        if isinstance(x, (int, float, str, bool, type(None))):
            return x
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        return repr(type(x))

    return {
        'class_name': obj.class_name if isinstance(obj, PersistentObj)
        else type(obj).__name__,
        'init_args': plain(state.get('_init_args', ())),
        'init_kwargs': plain(state.get('_init_kwargs', {})),
    }


def legacy_pkl_to_npz(pkl_path: str, npz_path: str,
                      keys: tuple[str, ...] = ('G_ema', 'G', 'D')
                      ) -> dict[str, np.ndarray]:
    """Extract every network in a legacy pickle to one flat npz.

    The top level of a StyleGAN training pickle is a plain dict
    ``{'G': ..., 'D': ..., 'G_ema': ..., 'training_set_kwargs': ...,
    'augment_pipe': ...}`` (``legacy.py``); arrays are saved as
    ``<key>.<dotted_param_name>``.  Returns the flat dict."""
    data = load_stubbed(pkl_path)
    flat: dict[str, np.ndarray] = {}
    if isinstance(data, dict):
        for key in keys:
            if data.get(key) is not None:
                sub = flatten_state_dict(data[key])
                flat.update({f'{key}.{k}': v for k, v in sub.items()})
    else:
        flat.update(flatten_state_dict(data))
    if npz_path:
        np.savez(npz_path, **flat)
    return flat
