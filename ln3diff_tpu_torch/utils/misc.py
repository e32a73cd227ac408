"""Small utilities: EasyDict, class registry, shape asserts, the bf16
weight cast.

Port of ``ln3diff_tpu/utils/misc.py``, itself a rewrite of the
reference's ``dnnlib/util.py`` (``EasyDict:50``,
``construct_class_by_name:331``) and ``utils/torch_utils/misc.py``
(``assert_shape:97``, ``InfiniteSampler:140``), with ``cast_floating``
(:111) over a module or a state dict of tensors.
"""

from __future__ import annotations

import importlib
from typing import Iterator

import numpy as np


class EasyDict(dict):
    """Attribute-access dict (reference dnnlib.EasyDict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def optional_import(name: str):
    """Import an optional dependency; None when absent.

    Also returns None for test-harness stand-in modules (marked
    ``__ln3diff_stub__``) that the reference-parity import shim leaves in
    ``sys.modules`` — a plain ``try: import x`` would mistake those for a
    real installation and take the dependency-present code path.
    """
    try:
        mod = importlib.import_module(name)
    except Exception:
        return None
    root = importlib.import_module(name.partition('.')[0])
    if getattr(root, '__ln3diff_stub__', False):
        return None
    return mod


def get_obj_by_name(name: str):
    """'pkg.module.Class' → class object."""
    module_name, _, obj_name = name.rpartition('.')
    module = importlib.import_module(module_name)
    return getattr(module, obj_name)


def construct_class_by_name(class_name: str, *args, **kwargs):
    """reference ``dnnlib.util.construct_class_by_name``."""
    return get_obj_by_name(class_name)(*args, **kwargs)


def assert_shape(tensor, ref_shape):
    """reference ``misc.assert_shape``: None entries are wildcards."""
    assert len(tensor.shape) == len(ref_shape), (
        f'Wrong number of dimensions: got {len(tensor.shape)}, '
        f'expected {len(ref_shape)}')
    for idx, (size, ref_size) in enumerate(zip(tensor.shape, ref_shape)):
        if ref_size is None:
            continue
        assert int(size) == ref_size, (
            f'Wrong size for dimension {idx}: got {size}, '
            f'expected {ref_size}')


class InfiniteSampler:
    """Shuffled infinite index stream over a dataset size, shardable by
    (rank, num_replicas) (reference ``misc.InfiniteSampler`` /
    ``dnnlib InfiniteSampler``)."""

    def __init__(self, dataset_size: int, rank: int = 0,
                 num_replicas: int = 1, shuffle: bool = True, seed: int = 0,
                 window_size: float = 0.5):
        assert dataset_size > 0
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))
        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield int(order[i])
            if window >= 2 and rnd is not None:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1


def cast_floating(obj, dtype):
    """Every floating tensor of ``obj`` — a ``torch.nn.Module`` (cast in
    place and returned) or a (nested) mapping of tensors — cast to
    ``dtype``; other tensors and values stay as they are.

    Inference-time weight storage: a module that computes in bf16 casts
    its f32 weights at every call, so storing them in bf16 gives the same
    output from half the weight bytes.  Not for f32-compute models or
    training state."""
    import torch
    if isinstance(obj, torch.nn.Module):
        return obj.to(dtype)
    if isinstance(obj, dict):
        return {k: cast_floating(v, dtype) for k, v in obj.items()}
    if torch.is_tensor(obj) and obj.is_floating_point():
        return obj.to(dtype)
    return obj
