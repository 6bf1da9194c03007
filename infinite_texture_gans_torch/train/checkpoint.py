"""Write and read framework ``.ckpt`` checkpoints; resume a train state;
rebuild the generator.

Port of ``save_checkpoint`` (:35-56), ``AsyncCheckpointer`` (:64-130),
``load_checkpoint``, ``restore_train_state`` (:166-204) and
``load_generator_from_checkpoint`` of
``infinite_texture_gans_tpu/train/checkpoint.py``. File layout
(docs/CHECKPOINT.md): ``MAGIC``, a little-endian u64 length, the JSON
metadata (``meta.args`` holds the training flags), then the flax msgpack
body, written and read by the port's own encoder and decoder
(``train/msgpack.py``), so checkpoints cross between the two packages in
both directions. The reference ``.pth`` import is not ported yet.
"""

from __future__ import annotations

import copy
import json
import os
import queue
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from infinite_texture_gans_torch import resolve_device
from infinite_texture_gans_torch.config import dict_to_args, generator_kwargs
from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.train import msgpack
from infinite_texture_gans_torch.weights import from_jax_variables, map_leaves

MAGIC = b"ITGTPU1\n"


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """``payload``: nested dicts of arrays (numpy arrays, numpy scalars or
    tensors) plus JSON-serialisable metadata under 'meta'; the reference's
    ``save_checkpoint`` format."""
    body = {k: v for k, v in payload.items() if k != "meta"}
    meta_blob = json.dumps(payload.get("meta", {})).encode()
    blob = msgpack.packb(body)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(meta_blob)))
        f.write(meta_blob)
        f.write(blob)


class AsyncCheckpointer:
    """Checkpoint writer on one background thread, so the train loop keeps
    dispatching steps while a save is copied to the host and written.

    :meth:`submit` snapshots every tensor of the payload with a ``clone()``
    on the current stream, which orders the snapshot before the next step
    (or graph replay) overwrites the live tensors, and records a CUDA event
    after the clones. The worker waits on that event from a stream of its
    own (never a capture stream, never the legacy default stream), copies
    the snapshot to the host there and writes the file with
    :func:`save_checkpoint`; a step captured meanwhile on the main thread
    is unaffected (captures run in ``thread_local`` error mode,
    ``ops/graphs.py``). ``meta`` is deep-copied at submit (the loop appends
    to its loss lists in place). One worker writes the saves in submission
    order. A worker's error is raised again at the next :meth:`submit` or
    :meth:`wait`, then cleared. :meth:`wait` drains the queue; call it
    before reading a checkpoint back or returning from training.
    ``save_seconds`` holds (path, seconds on the worker) per written save."""

    def __init__(self) -> None:
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._thread: Optional[threading.Thread] = None
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.save_seconds: List[Tuple[str, float]] = []

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            path, payload, meta, event, stream = item
            try:
                t0 = time.perf_counter()
                save_checkpoint(path, {**self._to_host(payload, event, stream), "meta": meta})
                self.save_seconds.append((path, time.perf_counter() - t0))
            except Exception as e:  # raised again by submit() or wait()
                self._errors.append(e)

    @staticmethod
    def _to_host(payload: Dict[str, Any], event, stream) -> Dict[str, Any]:
        """The snapshot's tensors as CPU tensors: on the card, copied on the
        worker's ``stream`` once the snapshot's ``event`` has completed."""
        if event is None:
            return payload
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            return map_leaves(payload, lambda t: t.cpu() if isinstance(t, torch.Tensor) else t)

    def _raise_pending(self) -> None:
        if self._errors:
            err, self._errors = self._errors[0], []
            raise err

    def submit(self, path: str, payload: Dict[str, Any]) -> None:
        self._raise_pending()
        payload = dict(payload)
        meta = copy.deepcopy(payload.pop("meta", {}))
        devices = set()

        def snap(t):
            if not isinstance(t, torch.Tensor):
                return copy.deepcopy(t)
            if t.is_cuda:
                devices.add(t.device)
            return t.detach().clone(memory_format=torch.contiguous_format)

        payload = map_leaves(payload, snap)
        if len(devices) > 1:
            raise ValueError(f"a checkpoint's tensors lie on one device, not on {sorted(devices)}")
        event = stream = None
        if devices:
            dev = devices.pop()
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            stream = self._streams.setdefault(dev, torch.cuda.Stream(device=dev))
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        self._q.put((path, payload, meta, event, stream))

    def wait(self) -> None:
        """Block until every submitted save is on disk; raise a pending error."""
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        self._raise_pending()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The stored trees (numpy arrays; bfloat16 as torch tensors) plus the
    metadata under 'meta'."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(
                f"{path}: not a framework .ckpt (reference .pth import is not ported yet)"
            )
        (meta_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(meta_len).decode())
        tree = msgpack.unpackb(f.read())
    tree["meta"] = meta
    return tree


def restore_train_state(state, ckpt: Dict[str, Any], steps_per_epoch: int = 0) -> int:
    """Restore a full train state from a framework checkpoint, in place.

    ``state`` is a fresh ``train_step.TrainState``; every tensor of it is
    overwritten with ``copy_`` / ``fill_`` into its own storage, since a
    captured step reads those storages. G and D take the stored variables
    (parameters, BN statistics: G's and those of a ``--norm_layer_D batch``
    D; SN vectors: D's and those of a ``--spec_norm_G`` G); each Adam state takes
    the stored ``mu`` and ``nu`` as ``exp_avg`` and ``exp_avg_sq`` and the
    stored ``count`` as every parameter's ``step`` (the inverse of
    ``train_step.optimizer_tree``), so the bias correction continues; the
    EMA is restored when both sides have one. ``state.step`` becomes
    ``epoch * steps_per_epoch``, so the learning-rate schedules continue.
    A checkpoint whose names or shapes do not fit raises before anything
    is written. Returns the stored epoch."""
    pairs: List[Tuple[str, torch.Tensor, torch.Tensor]] = []

    def match(what: str, dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
        if set(dst) != set(src):
            raise ValueError(f"{what}: the checkpoint lacks {sorted(set(dst) - set(src))} and "
                             f"has {sorted(set(src) - set(dst))} the state does not")
        for k, t in dst.items():
            if tuple(src[k].shape) != tuple(t.shape):
                raise ValueError(f"{what}: {k} is {tuple(src[k].shape)} in the checkpoint, "
                                 f"{tuple(t.shape)} in the state")
            pairs.append((f"{what} {k}", t, src[k]))

    counts = []
    for name, module, opt in (("G", state.G, state.opt_G), ("D", state.D, state.opt_D)):
        match(name, module.state_dict(),
              from_jax_variables(ckpt[f"net{name}_variables"], spectral=True))
        adam = ckpt[f"opt_{name}"]["0"]
        params = dict(module.named_parameters())
        for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            match(f"Adam {name} {moment}", {n: opt.state[p][key] for n, p in params.items()},
                  from_jax_variables({"params": adam[moment]}))
        counts += [(opt.state[p]["step"], float(adam["count"])) for p in params.values()]
    if state.ema is not None and ckpt.get("ema"):
        match("EMA", state.ema, from_jax_variables(ckpt["ema"]))
    with torch.no_grad():
        for _, dst, src in pairs:
            dst.copy_(src)
        for step, count in counts:
            step.fill_(count)
    epoch = int(ckpt["meta"].get("epoch", 0))
    state.step = epoch * steps_per_epoch
    return epoch


def load_generator_from_checkpoint(
    path: str, ema: Optional[bool] = None, *, device="cuda",
    ckpt: Optional[Dict[str, Any]] = None, fuse_up: Optional[str] = None,
):
    """Rebuild the eval generator from a checkpoint's stored config (SN off,
    3x3 grid, as the reference does) and load its weights: a
    ``--spec_norm_G`` checkpoint's raw weights, its ``spectral`` vectors
    left out, as the reference's SN-off module ignores them.

    ``ema``: use the stored EMA snapshot when the checkpoint has one.
    ``fuse_up`` overrides the stored one ('all': the fused eval tail, as
    the reference's sample CLI clones the generator with its flag).
    Returns (generator in eval mode on ``device``, args namespace)."""
    dev = resolve_device(device)
    if ckpt is None:
        ckpt = load_checkpoint(path)
    args = dict_to_args(ckpt["meta"]["args"])
    if fuse_up is not None:
        args.fuse_up = fuse_up
    kwargs = generator_kwargs(args)
    # the eval tail is the port's choice: a stored --chw_tail off (a CPU
    # reference path in the port, a TPU placement in the reference) would
    # refuse the card
    kwargs.update(SN=False, num_patches_h=3, num_patches_w=3, chw_tail="auto")
    gen = ResidualPatchGenerator(**kwargs)
    if ema and ckpt.get("ema"):
        variables = {"params": ckpt["ema"]["params"], "batch_stats": ckpt["ema"]["batch_stats"]}
    else:
        variables = ckpt["netG_variables"]
    gen.load_state_dict(from_jax_variables(variables), strict=True)
    return gen.to(dev).eval(), args
