"""A pool of gloo ranks for the port's multi-rank tests.

``RankPool(world, directory)`` spawns ``world`` processes that join one
gloo process group over a file store in ``directory`` (no port, so test
files can run side by side) and then wait for tasks: ``pool.run(fn,
*args)`` calls ``fn(*args)`` on every rank and returns the ranks' results
in rank order.  ``fn`` must live in a module that imports neither JAX nor
the JAX package (``tests/_torch_parallel_tasks.py``); arguments and
results cross the process boundary pickled, so they are numpy arrays,
numbers and containers of them.  One pool serves a whole test module.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import traceback

TIMEOUT_S = 600


def _worker(rank: int, world: int, store_path: str, tasks, results):
    os.environ['OMP_NUM_THREADS'] = '1'
    import datetime

    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    # a rank that fails mid-task leaves the others in a collective: let
    # them fail too instead of waiting out gloo's default 30 minutes
    dist.init_process_group('gloo', store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            module, name, args, kwargs = item
            try:
                fn = getattr(importlib.import_module(module), name)
                results.put((rank, True, fn(*args, **kwargs)))
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int, directory: str):
        ctx = mp.get_context('spawn')
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        store = os.path.join(str(directory), f'store_{world}')
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, world, store, self.tasks[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank → the results by rank."""
        for q in self.tasks:
            q.put((fn.__module__, fn.__name__, args, kwargs))
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=TIMEOUT_S)
            except queue.Empty:
                self.close()
                raise RuntimeError(f'{fn.__name__}: a rank gave no result '
                                   f'within {TIMEOUT_S} s')
            if ok:
                out[rank] = value
            else:
                errors.append(f'rank {rank}:\n{value}')
        if errors:
            raise RuntimeError('\n'.join(errors))
        return out

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
