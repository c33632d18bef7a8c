"""Start the ranks of one host: the counterpart of the JAX searcher's
default mesh (one device per shard).

``run_ranks(fn, world, backend, *args)`` starts ``world`` fresh Python
processes (``spawn``: the caller may hold a CUDA context, which a fork
must not inherit), joins them into one process group through a
``FileStore`` in a temporary directory (no TCP port is needed), calls
``fn(*args)`` on every rank and returns each rank's result, rank order.
``fn`` and its arguments must pickle: a module-level function.

A rank that raises makes the call raise with its traceback, and the other
ranks are stopped; every rank's collectives time out after ``timeout``
seconds, and the call itself raises once that long has passed, so it
never hangs, and a rank dies with its launcher. Ranks find their card
through ``LOCAL_RANK`` (the rank), split the host's cores between them and
talk over the loopback interface, as processes of one host do.
"""

from __future__ import annotations

import ctypes
import datetime
import os
import pickle
import queue
import signal
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEFAULT_TIMEOUT = 600.0


def _die_with_parent():
    """Have Linux kill this process when its parent exits, so that no rank
    outlives a launcher that was itself killed."""
    if sys.platform.startswith("linux"):
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
        if os.getppid() == 1:  # the parent died before the call
            os._exit(1)


def _rank_main(rank, world, backend, store_path, timeout, call, results):
    _die_with_parent()
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world)
    # every rank is on this host: gloo and NCCL bootstrap over loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout),
    )
    with open(call, "rb") as f:
        fn, args = pickle.load(f)
    out = fn(*args)
    dist.destroy_process_group()
    results.put((rank, out))


def _first_failure(ctx, world):
    """The traceback of the rank that failed first (a failing rank takes
    down the collectives of the others, which then fail too), by the time
    its error file was written."""
    failed = sorted((os.stat(f).st_mtime_ns, r)
                    for r, f in enumerate(ctx.error_files)
                    if os.path.exists(f))
    if not failed:
        return None
    first = failed[0][1]
    also = (f" (then ranks {[r for _, r in failed[1:]]})"
            if len(failed) > 1 else "")
    with open(ctx.error_files[first], "rb") as f:
        trace = pickle.load(f)
    return f"rank {first} of {world} failed{also}:\n{trace}"


def _drain(results, out):
    while True:
        try:
            rank, value = results.get(timeout=0.05)
        except queue.Empty:
            return
        out[rank] = value


def run_ranks(fn, world: int, backend: str, *args,
              timeout: float = DEFAULT_TIMEOUT):
    """``fn(*args)`` on ``world`` ranks of a new ``backend`` process group
    ("gloo" or "nccl"); the list of their results."""
    if world < 1:
        raise ValueError(f"world must be at least 1, got {world}")
    results = mp.get_context("spawn").Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="diagon_ranks_") as tmp:
        # fn and its arguments go through a file: a spawn whose arguments
        # outgrow the pipe waits until its rank has unpickled them (and
        # imported fn's module), which would start the ranks one by one
        call = os.path.join(tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(world, backend, os.path.join(tmp, "store"), timeout, call,
                  results),
        )
        deadline = time.monotonic() + timeout
        try:
            # join raises once a rank has failed, and stops the others;
            # the results are drained meanwhile, so no rank blocks on them
            while not ctx.join(timeout=0.5):
                _drain(results, out)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} of "
                        f"{world} gave no result within {timeout:.0f} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RuntimeError(_first_failure(ctx, world) or str(e)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            for f in ctx.error_files:
                if os.path.exists(f):
                    os.unlink(f)
    while len(out) < world:
        rank, value = results.get(timeout=60)
        out[rank] = value
    return [out[r] for r in range(world)]
