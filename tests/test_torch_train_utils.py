"""The port's checkpoints, preemption guard and training statistics
(``training/checkpoint.py``, ``training/preemption.py``,
``utils/training_stats.py``) on one process, with the JAX package's
statistics collector as the reference on the same reports."""

import os
import signal

import numpy as np
import pytest
import torch

from ln3diff_tpu.training import checkpoint as jckpt
from ln3diff_tpu.utils import training_stats as jstats
from ln3diff_tpu_torch.models.dit import DiTConfig, DiT_TriLatent
from ln3diff_tpu_torch.training import checkpoint as tckpt
from ln3diff_tpu_torch.training.ldm_trainer import LDMTrainConfig, LDMTrainer
from ln3diff_tpu_torch.training.preemption import PreemptionGuard
from ln3diff_tpu_torch.utils import training_stats as tstats

if os.environ.get('PYTEST_XDIST_WORKER'):
    torch.set_num_threads(1)


def _trainer(seed=0):
    cfg = DiTConfig(input_size=8, patch_size=2, in_channels=4,
                    hidden_size=32, depth=1, num_heads=2, variant='text',
                    context_dim=16, dtype=torch.float32)
    return LDMTrainer(DiT_TriLatent(cfg), LDMTrainConfig(
        objective='flow_matching', lr=1e-3, triplane_scaling_divider=1.0,
        ema_rate=0.5, log_interval=10**6), seed=seed, device='cpu')


def _data(on_fetch=None):
    rng = np.random.default_rng(0)
    i = 0
    while True:
        i += 1
        if on_fetch is not None:
            on_fetch(i)
        yield {'latent': rng.standard_normal((2, 8, 8, 12))
               .astype(np.float32),
               'context': {'crossattn': np.ones((2, 7, 16), np.float32)}}


def _state_tensors(state):
    out = {f'params.{k}': v for k, v in state.params.items()}
    out.update({f'ema.{n}.{k}': v for n, e in state.ema_params.items()
                for k, v in e.items()})
    out.update({f'{m}.{k}': v for m in ('mu', 'nu')
                for k, v in state.opt_state[m].items()})
    return out


def test_checkpoint_round_trip_and_retention(tmp_path):
    tr = _trainer()
    tr.run_loop(_data(), num_steps=2)
    mgr = tckpt.CheckpointManager(str(tmp_path / 'ckpt'), max_to_keep=2)
    assert mgr.latest_step() is None
    assert mgr.restore(tr.state) is None
    for step in (2, 5, 9):
        mgr.save(step, tr.state)
    assert mgr.all_steps() == [5, 9] and mgr.latest_step() == 9
    saved = {k: v.clone() for k, v in _state_tensors(tr.state).items()}
    # a second trainer from another seed takes the first one's state
    other = _trainer(seed=1)
    other.run_loop(_data(), num_steps=1)
    params_before = dict(other.model.named_parameters())
    restored = mgr.restore(other.state)
    assert restored is other.state and other.state.step == 2
    assert other.state.opt_state['count'] == 2
    for k, v in _state_tensors(other.state).items():
        assert torch.equal(v, saved[k]), k
    # the module's own parameters were restored in place
    for k, p in other.model.named_parameters():
        assert p is params_before[k]
        assert torch.equal(p, saved[f'params.{k}']), k
    mgr.close()
    # training goes on identically from the restored state
    raw = next(_data())
    batch = {'latent': torch.from_numpy(raw['latent']),
             'context': {'crossattn': torch.from_numpy(
                 raw['context']['crossattn'])}}
    for t in (tr, other):
        t.generator = torch.Generator().manual_seed(5)
    a, b = tr.train_step(batch), other.train_step(batch)
    assert float(a['loss']) == float(b['loss'])
    for k, p in tr.state.params.items():
        assert torch.equal(p, other.state.params[k]), k


def test_checkpoint_rejects_another_model(tmp_path):
    tr = _trainer()
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=3)
    tr.init_state()
    mgr.save(1, tr.state)
    tr.state.params.pop(next(iter(tr.state.params)))
    with pytest.raises(ValueError, match='params'):
        mgr.restore(tr.state)


def test_numpy_checkpoint_and_resume_step(tmp_path):
    tr = _trainer()
    sd = dict(tr.model.state_dict())
    path = str(tmp_path / 'model.npz')
    tckpt.save_numpy_checkpoint(path, sd)
    like = {k: torch.zeros_like(v) for k, v in sd.items()}
    back = tckpt.load_numpy_checkpoint(path, like)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    for name in ('model_rec0123456.pt', 'ema_0.9999_0000042.safetensors',
                 'model.pt', 'x1234567.bin'):
        assert tckpt.parse_resume_step_from_filename(name) == \
            jckpt.parse_resume_step_from_filename(name)


def test_guard_latches_sigterm_and_restores_the_handler():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.preempted and not guard.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted
        assert guard.should_stop()
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_chains_the_previous_python_handler():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        with PreemptionGuard() as guard:
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.preempted
        assert hits == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is not guard._handler
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_run_loop_stops_at_the_step_boundary(tmp_path):
    """SIGTERM while the second batch is fetched: step 2 completes, the
    loop stops, the checkpoint of step 2 is written."""
    tr = _trainer()

    def on_fetch(i):
        if i == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    mgr = tckpt.CheckpointManager(str(tmp_path))
    logs = []
    with PreemptionGuard() as guard:
        state = tr.run_loop(_data(on_fetch), num_steps=10, guard=guard,
                            log=logs.append)
        mgr.save(state.step, state)
    assert guard.preempted and state.step == 2
    assert logs == [{'stopped_after_step': 2}]
    assert mgr.latest_step() == 2


def test_stats_collector_matches_jax():
    rng = np.random.default_rng(2)
    reports = [('loss', rng.standard_normal(5)), ('loss', 3.5),
               ('gnorm', rng.uniform(0, 2, (2, 3))), ('loss', []),
               ('empty', [])]
    j, t = jstats.StatsCollector(), tstats.StatsCollector()
    for name, v in reports:
        j.report(name, v)
        t.report(name, torch.as_tensor(np.asarray(v, np.float32))
                 if name == 'gnorm' else v)
        j.report0(name + '0', v)
        t.report0(name + '0', v)
    want, got = j.as_dict(), t.as_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k]['num'] == want[k]['num']
        for m in ('mean', 'std'):
            np.testing.assert_allclose(got[k][m], want[k][m], rtol=1e-6)
    assert np.isnan(t.mean('missing')) and np.isnan(t.std('missing'))
    t.reset()
    assert t.as_dict() == {}
    tstats.report('x', 2.0)
    tstats.report0('x', 4.0)
    assert tstats.default_collector().mean('x') == 3.0
    tstats.default_collector().reset()
