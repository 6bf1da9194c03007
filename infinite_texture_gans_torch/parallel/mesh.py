"""The data axis: its devices, its ranks, and the processes that run them.

Port of ``infinite_texture_gans_tpu/parallel/mesh.py``. The reference's
users ran ``nn.DataParallel`` over ``--num_gpus`` / ``--gpu_list``; the
JAX package put a one-axis ``data`` mesh in its place (``--mesh data:N``).
Here the axis is ``torch.distributed``: one process per device, NCCL
between cards, gloo between CPU processes.

* :func:`make_mesh` parses the flags into a :class:`Mesh` (the world size,
  each rank's device and the backend), None for one device;
* :func:`run_ranks` starts one process per rank, each joining the group
  through a ``file://`` rendezvous in a temporary directory (so concurrent
  runs never contend for a port), runs a module-level function there and
  returns each rank's result; a rank that fails, or a run past its
  ``timeout``, raises in the caller and stops every rank;
* inside a rank, :func:`current_axis` is its :class:`DataAxis` (the group,
  its rank and the world size); :func:`shard_batch` takes the rank's slice
  of a global batch and :func:`replicate` broadcasts rank 0's tensors to
  every rank. :func:`data_axis` joins a group in the calling process (a
  world of one, say) without starting any.

Ranks other than 0 write nothing to standard output: rank 0 speaks for the
run.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A data axis of ``size`` ranks: rank i runs on ``devices[i]`` and the
    ranks talk through ``backend`` ('nccl' between cards, 'gloo' otherwise)."""

    size: int
    devices: Tuple[str, ...]
    backend: str


def _available(device: str) -> int:
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def make_mesh(spec: Optional[str] = None, num_devices: Optional[int] = None,
              device_list: Optional[Sequence[int]] = None, device: str = "cuda") -> Optional[Mesh]:
    """The data axis of ``--mesh`` (``spec``: 'data:N', or 'data:' for every
    device) or else ``--num_gpus`` (``num_devices``), on the devices of
    ``--gpu_list`` (``device_list``: indices, as the reference picks
    devices) or the first N; ``device`` 'cuda' (cards: cuda:i) or 'cpu'
    (one process each; the host's cores are its devices). None for one
    device. Raises the reference's errors for another axis, bad indices, a
    short list and too few devices. The backend is NCCL on cards, gloo on
    the CPU."""
    kind = torch.device(device).type
    if spec:
        axis, _, n = spec.partition(":")
        n = int(n) if n else _available(kind)
        if axis != "data":
            raise ValueError(f"unsupported mesh axis {axis!r}; expected 'data'")
    else:
        n = num_devices or 1
    if n <= 1:
        return None
    available = _available(kind)
    if device_list:
        bad = [i for i in device_list if i < 0 or i >= available]
        if bad:
            raise ValueError(f"--gpu_list indices {bad} out of range: only {available} devices "
                             "available")
        if len(set(device_list)) != len(device_list):
            raise ValueError(f"--gpu_list contains duplicates: {list(device_list)}")
        if len(device_list) < n:
            raise ValueError(f"--gpu_list has {len(device_list)} entries but the mesh needs "
                             f"{n} devices")
        indices = list(device_list[:n])
    else:
        indices = list(range(min(n, available)))
    if len(indices) < n:
        raise ValueError(f"requested {n} devices, only {len(indices)} available")
    devices = tuple(f"cuda:{i}" if kind == "cuda" else "cpu" for i in indices)
    return Mesh(n, devices, "nccl" if kind == "cuda" else "gloo")


@dataclass(frozen=True)
class DataAxis:
    """This process's place on the data axis: the process ``group``, its
    ``rank`` in it, the world ``size`` and its ``device``."""

    group: Any
    rank: int
    size: int
    device: torch.device

    def shards(self, n: int) -> bool:
        """Whether a batch of ``n`` splits into equal slices, one a rank (the
        reference's rule for the fakes: ``n % size == 0`` and ``n >= size``)."""
        return n % self.size == 0 and n >= self.size

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``x``'s leading axis (equal slices)."""
        if not self.shards(x.shape[0]):
            raise ValueError(f"a batch of {x.shape[0]} does not split over {self.size} ranks")
        k = x.shape[0] // self.size
        return x[self.rank * k : (self.rank + 1) * k]

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (a picklable value)."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group,
                                   device=self.device if self.device.type == "cuda" else None)
        return box[0]


_AXIS: List[Optional[DataAxis]] = [None]


def current_axis() -> Optional[DataAxis]:
    """The calling process's :class:`DataAxis`, or None outside a rank."""
    return _AXIS[0]


@contextlib.contextmanager
def data_axis(mesh: Mesh, rank: int, init_method: str, timeout_s: float = 1800.0):
    """Join ``mesh``'s group as ``rank`` (``init_method``: a ``file://``
    path that every rank names) and make its :class:`DataAxis` the current
    one until the block ends, then leave the group."""
    device = torch.device(mesh.devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(mesh.backend, init_method=init_method, world_size=mesh.size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    before = _AXIS[0]
    _AXIS[0] = DataAxis(dist.group.WORLD, rank, mesh.size, device)
    try:
        yield _AXIS[0]
    finally:
        _AXIS[0] = before
        dist.destroy_process_group()


def _rank_main(rank: int, mesh: Mesh, init_method: str, fn: Callable, args: tuple,
               results, threads: Optional[int], timeout_s: float) -> None:
    if rank:
        sys.stdout = open(os.devnull, "w")
    if threads:
        torch.set_num_threads(threads)
    try:
        with data_axis(mesh, rank, init_method, timeout_s):
            out = fn(*args)
        # plain pickle: the queue's own would hand tensors over as shared
        # memory, which this process takes with it when it exits
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn: Callable, mesh: Mesh, args: tuple = (), timeout: Optional[float] = None,
              threads: Optional[int] = None, tmpdir: Optional[str] = None) -> List[Any]:
    """``fn(*args)`` in one new process per rank of ``mesh``, each inside
    :func:`data_axis`; returns the ranks' results in rank order. ``fn`` and
    ``args`` are pickled (a module-level function; results are best host
    values). ``threads``: each rank's intra-op threads (default on the CPU:
    the host's cores shared out). The rendezvous file lives in a new
    directory under ``tmpdir`` (the system's default). A rank that raises,
    dies, or outlives ``timeout`` seconds makes this raise RuntimeError,
    after every rank is stopped."""
    ctx = mp.get_context("spawn")
    if threads is None and all(d == "cpu" for d in mesh.devices):
        threads = max(1, (os.cpu_count() or 1) // mesh.size)
    collective_s = timeout if timeout is not None else 1800.0
    with tempfile.TemporaryDirectory(prefix="itg_ranks_", dir=tmpdir) as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(r, mesh, init, fn, args, results, threads,
                                                      collective_s), daemon=True)
                 for r in range(mesh.size)]
        for p in procs:
            p.start()
        out, errors = {}, []
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while len(out) + len(errors) < mesh.size:
                if deadline is not None and time.monotonic() > deadline:
                    errors.append(f"timed out after {timeout} s")
                    break
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead and results.empty():
                        time.sleep(0.5)  # a rank's last put may still be in flight
                        if results.empty():
                            errors.append(f"rank {procs.index(dead[0])} exited with code "
                                          f"{dead[0].exitcode}")
                            break
                    continue
                if ok:
                    out[rank] = pickle.loads(value)
                else:
                    errors.append(f"rank {rank} raised:\n{value}")
                    break
        finally:
            for p in procs:
                if errors:
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
        if errors:
            raise RuntimeError(f"data-parallel run on {mesh.size} ranks failed: {errors[0]}")
    return [out[r] for r in range(mesh.size)]


def shard_batch(x: torch.Tensor, axis: Optional[DataAxis] = None) -> torch.Tensor:
    """The calling rank's slice of the global batch ``x`` (its leading
    axis, split in equal slices; ``axis`` defaults to :func:`current_axis`);
    ``x`` itself outside a rank."""
    axis = axis or current_axis()
    return x if axis is None else axis.shard(x)


def replicate(tensors: Iterable[torch.Tensor], axis: Optional[DataAxis] = None) -> None:
    """Broadcast rank 0's values of ``tensors`` (parameters, buffers,
    optimizer state) to every rank, in place; nothing outside a rank."""
    axis = axis or current_axis()
    if axis is None:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=axis.group)
