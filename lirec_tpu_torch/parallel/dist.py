"""Processes over ``torch.distributed`` (counterpart of the process-group
half of lirec_tpu/parallel/mesh.py).

The JAX package lays a ``('data', 'model')`` mesh over the devices of one
program and lets XLA insert the collectives. The port runs one process per
card instead (parallel/mesh.py lays them out as the mesh): each computes
its own contiguous block of rows of every global batch, and one
all-reduce of its flat gradient buffers a step sums the gradients over
the data axis (parallel/step.py); under a model axis each also holds its
slice of the tensor-parallel layers.

* ``initialize_distributed``: joins a process group (NCCL for ``cuda``,
  gloo for ``cpu``) at ``tcp://<coordinator>`` or at an ``init_method`` URL
  such as ``file://<path>`` (a FileStore, for tests); each rank takes the
  card ``cuda:<rank % device_count>``.
* ``world`` / ``rank``: 1 and 0 where no group is initialised.
* ``make_mesh`` / ``process_local_slice``: parallel/mesh.py's
  ``make_mesh`` and ``process_local_slice``, here too.
* ``barrier``, ``all_gather_object``.
* ``sharded_batch`` / ``batch_shard`` / ``batch_total``: inside a
  data-parallel step, the forward draws its dropout masks and loss samples
  at the global batch's shape and keeps its own rows, and the loss's means
  divide by counts summed over the group (models/layers.py,
  models/losses.py); the counts are summed over the data axis only.
* ``spawn``: ``world`` local ranks in processes of the ``spawn`` start
  method, joined under a time limit; a rank that fails or hangs fails the
  call with its traceback.

``host_copy``'s counterpart is parallel/mesh.gather_state.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

from lirec_tpu_torch.parallel.mesh import (
    Mesh2D, make_mesh, process_local_slice,
)

__all__ = [
    "RankResult", "initialize_distributed", "world", "rank",
    "in_rank", "make_mesh", "process_local_slice", "barrier",
    "all_gather_object", "sharded_batch", "batch_shard", "batch_total",
    "spawn",
]

DEFAULT_TIMEOUT = 600  # seconds, for a collective and for spawn's join

_SHARD: contextvars.ContextVar = contextvars.ContextVar("batch_shard",
                                                        default=None)
_IN_RANK = False  # set in a process that spawn() started, while it runs fn


class RankResult(NamedTuple):
    """What one spawned rank returned, and its kernel launch counts
    (ops/dispatch.launches) at the end of its run."""

    value: Any
    launches: dict


def _group():
    import torch.distributed as td

    return td if td.is_available() and td.is_initialized() else None


def world() -> int:
    td = _group()
    return td.get_world_size() if td else 1


def rank() -> int:
    td = _group()
    return td.get_rank() if td else 0


def in_rank() -> bool:
    """True inside a rank process that ``spawn`` started."""
    return _IN_RANK


def initialize_distributed(coordinator: str, num_processes: int,
                           process_id: int, device="cuda",
                           backend: Optional[str] = None,
                           timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the process group of `num_processes` processes as rank
    `process_id` (counterpart of mesh.initialize_distributed, which skips
    a world of one; here a world of one is a group too, and the CLI calls
    this only for more). `coordinator` is HOST:PORT (rank 0 listens there)
    or an init_method URL (``file://<path>``). The backend defaults to NCCL
    for a ``cuda`` device and gloo for ``cpu``; a CUDA rank first takes
    the card ``cuda:<process_id % device_count>``."""
    import torch
    import torch.distributed as td

    kind = torch.device(device).type
    if kind == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    init = coordinator if "://" in coordinator else "tcp://" + coordinator
    td.init_process_group(
        backend or ("nccl" if kind == "cuda" else "gloo"), init_method=init,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def barrier(tag: str = "") -> None:
    """Wait for every process of the group (no-op alone). `tag` names the
    program point in a timeout's message."""
    td = _group()
    if td is None or td.get_world_size() == 1:
        return
    try:
        if td.get_backend() == "nccl":
            import torch

            td.barrier(device_ids=[torch.cuda.current_device()])
        else:
            td.barrier()
    except RuntimeError as err:
        raise RuntimeError("barrier %r: %s" % (tag, err)) from err


def all_gather_object(obj, group=None) -> List:
    """[obj of rank 0, obj of rank 1, ...] of `group` (default: the whole
    process group; pickled through it); [obj] alone."""
    td = _group()
    if td is None or td.get_world_size(group) == 1:
        return [obj]
    out = [None] * td.get_world_size(group)
    td.all_gather_object(out, obj, group=group)
    return out


@contextlib.contextmanager
def sharded_batch(mesh: Optional[Mesh2D]):
    """Within: the forward and the loss see `mesh.rank`'s block of rows of
    a global batch of `mesh.size` blocks (see batch_shard). A mesh of one
    sets nothing, so a world of one runs the single-process code."""
    if mesh is None or mesh.size == 1:
        yield
        return
    token = _SHARD.set(mesh)
    try:
        yield
    finally:
        _SHARD.reset(token)


def batch_shard() -> Optional[Mesh2D]:
    """The active row block (sharded_batch), or None."""
    return _SHARD.get()


def batch_total(count):
    """A per-rank count summed over the data axis, without gradient, where
    a row block is active; else `count` itself."""
    mesh = _SHARD.get()
    if mesh is None:
        return count
    import torch.distributed as td

    total = count.detach().clone()
    td.all_reduce(total, group=mesh.data_group)
    return total


def _rank_main(fn, args, rank_id, world_size, init, device, backend,
               timeout, out_path):
    """The entry of a spawned rank: join the group, run fn(*args), save
    (value, launch counts) to `out_path`, or its traceback beside it."""
    global _IN_RANK
    import torch

    _IN_RANK = True
    # ranks share the node's cores (and torch's first multi-threaded CPU
    # ops have been seen to differ in the last digits): one thread each
    torch.set_num_threads(1)
    try:
        initialize_distributed(init, world_size, rank_id, device, backend,
                               timeout)
        from lirec_tpu_torch.ops import dispatch

        value = fn(*args)
        torch.save(RankResult(value, dispatch.launches())._asdict(),
                   out_path)
    except BaseException:
        # the time first: spawn reports the rank that failed first (a
        # failure ends the other ranks' collectives, and they fail after)
        with open(out_path + ".err", "w") as f:
            f.write("%d\n%s" % (time.time_ns(), traceback.format_exc()))
        raise
    finally:
        td = _group()
        if td is not None:
            td.destroy_process_group()


def spawn(fn: Callable, world_size: int, devices: str = "cpu",
          backend: Optional[str] = None,
          timeout: Optional[float] = DEFAULT_TIMEOUT, args: Sequence = (),
          workdir: Optional[str] = None) -> List[RankResult]:
    """Run ``fn(*args)`` in `world_size` local rank processes (the
    ``spawn`` start method; `fn` must be a module-level function) joined in
    one process group through a FileStore in `workdir` (default: a new
    temporary directory). `devices` is the ranks' device type, ``cpu`` or
    ``cuda`` (rank r takes card r % device_count); `backend` defaults to
    gloo for ``cpu`` and NCCL for ``cuda``. Each rank runs torch on one
    thread. Returns every rank's RankResult, in rank order.

    Every rank must finish within `timeout` seconds, which also bounds
    each of its collectives (None: no deadline for the run, DEFAULT_TIMEOUT
    for a collective). A rank that raises, dies or is still running at the
    deadline ends the call: the other ranks are stopped, and the error
    carries the failing rank's traceback. Nothing is retried."""
    import torch

    ctx = multiprocessing.get_context("spawn")
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="lirec_spawn_"))
        store = os.path.join(workdir, "store")
        if os.path.exists(store):
            os.remove(store)  # a FileStore file is for one group only
        outs = [os.path.join(workdir, "rank%d.pt" % r)
                for r in range(world_size)]
        # not daemonic, so that a rank may start worker processes of its
        # own (data/pipeline.AssemblyPool); the finally below stops every
        # rank on failure and at the deadline
        procs = [ctx.Process(
            target=_rank_main, daemon=False,
            args=(fn, tuple(args), r, world_size, "file://" + store, devices,
                  backend, timeout or DEFAULT_TIMEOUT, outs[r]))
            for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            _join(procs, outs, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return [RankResult(**torch.load(o, weights_only=False))
                for o in outs]


def _join(procs, outs, timeout: Optional[float]) -> None:
    """Wait for every rank; raise when one fails (naming the rank that
    failed first, _first_failure), or when the deadline (if any)
    passes."""
    deadline = None if timeout is None else time.monotonic() + timeout
    pending = {p.sentinel: r for r, p in enumerate(procs)}
    while pending:
        left = None if deadline is None else deadline - time.monotonic()
        ready = (multiprocessing.connection.wait(list(pending), left)
                 if left is None or left > 0 else [])
        if not ready:
            raise TimeoutError(
                "ranks %s of %d did not finish within %.0f s"
                % (sorted(pending.values()), len(procs), timeout))
        for sentinel in ready:
            r = pending.pop(sentinel)
            procs[r].join()
            if procs[r].exitcode != 0:
                r = _first_failure(procs, outs, r)
                raise RuntimeError("rank %d of %d failed:\n%s" % (
                    r, len(procs), _traceback(outs[r] + ".err",
                                              procs[r].exitcode)[1]))


def _first_failure(procs, outs, r: int, grace: float = 10.0) -> int:
    """The rank that failed first, given that rank `r` has failed: the
    others get `grace` seconds to end (a failed rank breaks its peers'
    collectives), then the earliest traceback written wins. A rank `r`
    that died without writing one (a signal) is the cause itself."""
    if _traceback(outs[r] + ".err", None)[0] is None:
        return r
    end = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    written = [(_traceback(o + ".err", None)[0], q)
               for q, o in enumerate(outs)]
    return min((t, q) for t, q in written if t is not None)[1]


def _traceback(path: str, exitcode):
    """(the time it was written in ns, the traceback) of a failed rank,
    or (None, what is known without one)."""
    try:
        with open(path) as f:
            stamp, text = f.read().split("\n", 1)
        return int(stamp), text
    except FileNotFoundError:
        return None, ("(no traceback: the process ended with code %s)"
                      % exitcode)
