# coding: utf-8
"""Start a group of ranks in this machine's processes: the dry run, the
smoke run's scale-out phase and the tests use it where `torchrun` would be
the user's launcher.

`run_ranks(fn, n)` spawns n processes (`torch.multiprocessing`, spawn);
each initializes the default process group over a FileStore in a temporary
directory (no port to collide), runs fn(rank, *args) and hands its result
back through a file. The group has a deadline: a rank that raises, or a
group still running at the deadline (a hung rendezvous or collective), is
ended and raises here.
"""

import datetime
import os
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, fn, n, backend, tmp, timeout, threads, args, env):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(n), **env)
    if threads:
        torch.set_num_threads(threads)
    if backend:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), n),
            rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        # the group reports only the first rank to fail, which may be one
        # whose peer failed first: every rank says its own error
        print(f"rank {rank} of {n} failed:\n{traceback.format_exc()}",
              file=sys.stderr, flush=True)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n, args=(), backend="gloo", timeout=300, threads=None,
              env=None):
    """[fn(rank, *args) for rank in range(n)], each in its own process of
    one process group over `backend`; fn must be importable (a module's
    top-level function) and return something torch.save takes. With
    backend None the ranks start with no group and `torchrun`'s variables,
    plus `env` (MASTER_ADDR, MASTER_PORT), for make_mesh to initialize it
    as under torchrun. Raises what a rank raised, or TimeoutError after
    `timeout` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, n, backend, tmp, timeout, threads, args,
                              env or {}),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{n} ranks of {getattr(fn, '__name__', fn)} still "
                        f"running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
