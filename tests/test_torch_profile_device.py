"""The per-op device table (``ln3diff_tpu_torch/scripts/profile_device.py``,
the port of ``scripts/scripts_lib/profile_device.py``):

* ``parse_trace`` / ``parse_trace_dir`` on a hand-made Chrome trace: one
  row per device kernel (kernels, copies and sets) by its full name,
  summed and counted, longest first, cut at ``top``, host events and
  counters left out; the newest trace of a directory is read; the CPU-op
  table with the ops' input shapes.
* ``profile_fn`` on the CPU: a warm-up call outside the trace, the
  profiler's own warm-up step (traced, discarded), then ``iters`` calls;
  a non-empty table of CPU ops, sorted by time, whose matmul counts
  ``iters`` calls.  A trace taken for a CUDA device
  that holds no kernel event raises (``torch.profiler`` at times records
  no CUDA activity).
* The CLI's arguments, and its step and ``main`` on the CPU with the
  DiT-L/2 preset swapped for a toy DiT: ``--what int8`` runs
  ``torch._int_mm``.
"""

import json
import os
import time

import pytest
import torch

from ln3diff_tpu_torch import config as tconfig
from ln3diff_tpu_torch.models.dit import DiTConfig
from ln3diff_tpu_torch.scripts import profile_device as pd

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)

K3 = ('void attention_kernel<__nv_bfloat16, 64>(CUtensorMap, CUtensorMap, '
      'float)')
K1 = 'void osg_forward_kernel<float>(float const*, float*)'


def _events():
    return [
        dict(ph='X', cat='kernel', name=K3, dur=30.0),
        dict(ph='X', cat='kernel', name=K3, dur=32.0),
        dict(ph='X', cat='kernel', name=K1, dur=50.0),
        dict(ph='X', cat='gpu_memcpy', name='Memcpy HtoD (Pageable -> Device)',
             dur=4.0),
        dict(ph='X', cat='gpu_memset', name='Memset (Device)', dur=1.0),
        dict(ph='X', cat='cpu_op', name='aten::mm', dur=500.0,
             args={'Input Dims': [[4, 8], [8, 2]]}),
        dict(ph='X', cat='cpu_op', name='aten::mm', dur=100.0,
             args={'Input Dims': [[4, 8], [8, 2]]}),
        dict(ph='X', cat='cpu_op', name='aten::add', dur=20.0),
        dict(ph='X', cat='cuda_runtime', name='cudaLaunchKernel', dur=900.0),
        dict(ph='i', cat='kernel', name=K3),            # no duration
        dict(ph='C', name='memory', args={'bytes': 1})]


def test_parse_trace_device_rows():
    rows = pd.parse_trace(_events())
    assert rows == [
        (62.0, 2, 'attention_kernel', K3),
        (50.0, 1, 'osg_forward_kernel', K1),
        (4.0, 1, 'Memcpy HtoD (Pageable -> Device)',
         'Memcpy HtoD (Pageable -> Device)'),
        (1.0, 1, 'Memset (Device)', 'Memset (Device)')]
    assert pd.parse_trace(_events(), top=2) == rows[:2]


def test_parse_trace_cpu_rows():
    rows = pd.parse_trace(_events(), device=False)
    assert rows == [(600.0, 2, 'aten::mm', '[[4, 8], [8, 2]]'),
                    (20.0, 1, 'aten::add', '')]


def test_parse_trace_dir_reads_the_newest(tmp_path):
    assert pd.parse_trace_dir(str(tmp_path)) == []
    old = tmp_path / 'a' / 'old.pt.trace.json'
    old.parent.mkdir()
    old.write_text(json.dumps({'traceEvents': _events()[:1]}))
    os.utime(old, (time.time() - 100, time.time() - 100))
    (tmp_path / 'new.pt.trace.json').write_text(
        json.dumps({'traceEvents': _events()}))
    assert pd.parse_trace_dir(str(tmp_path))[0][:2] == (62.0, 2)


@pytest.mark.parametrize('name,short', [
    (K3, 'attention_kernel'),
    ('void (anonymous namespace)::attention_kernel<64>(Params)',
     'attention_kernel'),
    ('ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn',
     'ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn'),
    ('void at::native::vectorized_elementwise_kernel<4, '
     'at::native::FillFunctor<float>, at::detail::Array<char*, 1> >(int, '
     'at::native::FillFunctor<float>, at::detail::Array<char*, 1>)',
     'at::native::vectorized_elementwise_kernel')])
def test_kernel_function_name(name, short):
    assert pd.kernel_function_name(name) == short


def test_profile_fn_on_the_cpu(tmp_path, capsys):
    lin = torch.nn.Linear(16, 8)
    x = torch.randn(4, 16)
    calls = []

    def fn():
        calls.append(1)
        return lin(x)
    rows = pd.profile_fn(fn, iters=3, trace_dir=str(tmp_path),
                         device='cpu')
    # a warm-up outside the trace, the profiler's discarded warm-up step,
    # then the 3 calls of the table
    assert len(calls) == 5
    assert rows and all(len(r) == 4 for r in rows)
    totals = [r[0] for r in rows]
    assert totals == sorted(totals, reverse=True)
    counts = {r[2]: r[1] for r in rows}
    assert counts.get('aten::linear') == 3, counts
    assert list(tmp_path.glob('*.pt.trace.json'))
    assert 'aten::linear' in capsys.readouterr().out


def test_profile_fn_raises_on_an_empty_device_table(monkeypatch):
    """A trace taken for a card that holds no kernel event — here the
    CPU's, where no CUDA activity can be recorded — raises."""
    monkeypatch.setattr(pd, '_sync', lambda device: None)
    with pytest.raises(RuntimeError, match='no CUDA kernel'):
        pd.profile_fn(lambda: torch.ones(4) * 2, iters=2, device='cuda',
                      quiet=True)


def test_cli_arguments():
    args = pd.build_parser().parse_args([])
    assert (args.what, args.iters, args.device) == ('dit', 20, 'cuda')
    args = pd.build_parser().parse_args(['--what', 'int8', '--iters', '3',
                                         '--device', 'cpu'])
    assert (args.what, args.iters, args.device) == ('int8', 3, 'cpu')
    with pytest.raises(SystemExit):
        pd.build_parser().parse_args(['--what', 'vae'])


@pytest.fixture
def toy_preset(monkeypatch):
    toy = DiTConfig(input_size=32, patch_size=8, in_channels=4,
                    hidden_size=32, depth=1, num_heads=2, context_dim=768,
                    dtype=torch.float32)
    monkeypatch.setattr(tconfig, 'denoiser_preset', lambda name: toy)
    return toy


@pytest.mark.parametrize('what', ['dit', 'int8'])
def test_cli_step_on_a_toy_dit(what, toy_preset):
    """The CLI's step with the DiT-L/2 preset swapped for a toy DiT:
    ``--what int8`` serves it with tanh GELU through ``torch._int_mm``."""
    step, model = pd.build_step(pd.build_parser().parse_args(
        ['--what', what, '--device', 'cpu']))
    assert model.cfg.quantized == (what == 'int8')
    assert model.cfg.exact_gelu == (what == 'dit')
    rows = pd.profile_fn(step, iters=2, top=200, quiet=True, device='cpu')
    names = {r[2] for r in rows}
    assert ('aten::_int_mm' in names) == (what == 'int8'), names


def test_cli_main_prints_the_table(toy_preset, capsys):
    rows = pd.main(['--iters', '2', '--device', 'cpu'])
    assert 0 < len(rows) <= 25
    assert rows[0][2] in capsys.readouterr().out
