"""Training data, sampled on the device.

Port of ``infinite_texture_gans_tpu/data/datasets.py``: ``_load_image``,
``SingleImageDataset`` (:26-103) and ``MultipleImagesDataset`` (:106-251),
the on-device samplers (``DeviceCropSampler``, ``DeviceMultiImageSampler``,
``RotatingMultiImageSampler``; :254-479, the sample bodies :482-556), the
host ``Prefetcher`` (:585-645) and ``prepare_data`` (:647-669).

The uint8 images are held on the device once; every step draws a batch of
random crops there with an explicit ``torch.Generator`` and normalises them
to [-1, 1] (the reference's RandomCrop + ToTensor + Normalize(0.5, 0.5)).
A multi-image directory is one zero-padded (N, Hmax, Wmax, C) stack with
each image's valid extent; each batch element draws (image, top, left)
inside that image, so padding is never read. A stack over the device cap
keeps a window of its images resident (:class:`RotatingMultiImageSampler`),
and where no window fits, or ``--batch_size 1`` meets images that cannot be
stacked, the host :class:`Prefetcher` ships batches from pinned memory.
The dataset is virtual: its length is ``--sampling``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def _load_image(path: str, ext: str) -> np.ndarray:
    """Decode an image file to (H, W, C) uint8. ``.txt`` holds a
    whitespace-separated grid of values in [0, 1] (binary geological
    images)."""
    if ext == "txt" or path.endswith(".txt"):
        arr = np.loadtxt(path).astype(np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return (arr * 255.0).clip(0, 255).astype(np.uint8)
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = (h - size) // 2
    left = (w - size) // 2
    return arr[top : top + size, left : left + size]


def _resize(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """(H, W, C) uint8 resized to (h, w) by PIL's default filter."""
    from PIL import Image

    im = Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
    out = np.asarray(im.resize((w, h)))
    return out[:, :, None] if out.ndim == 2 else out


def _normalize_np(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1], on the host."""
    return batch_u8.astype(np.float32) / 127.5 - 1.0


class SingleImageDataset:
    """One texture image; every sample is a random (or center) crop."""

    def __init__(self, path: str, ext: str = "jpg", center_crop: Optional[int] = None,
                 random_crop: Optional[int] = None, sampling: Optional[int] = 8000):
        self.img = _load_image(path, ext)
        self.center_crop = center_crop
        self.random_crop = random_crop
        self.sampling = sampling
        if center_crop:
            self.img = _center_crop(self.img, center_crop)

    def __len__(self) -> int:
        return self.sampling if self.sampling else 10000

    @property
    def img_ch(self) -> int:
        return self.img.shape[-1]


def normalize(batch_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1]."""
    return batch_u8.to(torch.float32) / 127.5 - 1.0


class DeviceCropSampler:
    """The texture on ``device`` as (H, W, C) uint8; :meth:`sample` draws a
    (batch, crop, crop, C) float32 batch there."""

    def __init__(self, dataset: SingleImageDataset, device):
        self.img = torch.from_numpy(np.array(dataset.img)).to(device)
        self.random_crop = dataset.random_crop

    def sample(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """``generator`` lives on the sampler's device."""
        h, w, c = self.img.shape
        if not self.random_crop:
            return normalize(self.img).expand(batch_size, h, w, c).contiguous()
        s = self.random_crop
        dev = self.img.device
        tops = torch.randint(0, h - s + 1, (batch_size,), generator=generator, device=dev)
        lefts = torch.randint(0, w - s + 1, (batch_size,), generator=generator, device=dev)
        ar = torch.arange(s, device=dev)
        rows = (tops[:, None] + ar)[:, :, None]
        cols = (lefts[:, None] + ar)[:, None, :]
        return normalize(self.img[rows, cols])


def _randbelow(span: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw in [0, span[i]) per element of the int64 tensor ``span``,
    from ``generator`` on span's device, capturable in a CUDA graph:
    ``torch.randint`` takes one bound for all elements, so a 62-bit draw is
    reduced modulo each bound (a bias below span / 2^62)."""
    r = torch.randint(0, 2**62, span.shape, generator=generator, device=span.device,
                      dtype=torch.int64)
    return torch.remainder(r, span)


class MultipleImagesDataset:
    """A directory of images, sorted by name; ``sampling`` (fewer than the
    files) draws that many of them with ``np.random.default_rng(seed)``.
    Images are decoded when first needed and cached; ``resize`` (h, w)
    resizes each through PIL, and ``center_crop`` crops each and resizes the
    crop to 64^2 (the reference's pipeline)."""

    def __init__(self, path: str, ext: str = "jpg", center_crop: Optional[int] = None,
                 random_crop: Optional[int] = None, resize: Optional[Tuple[int, int]] = None,
                 sampling: Optional[int] = None, seed: int = 0):
        self.path, self.ext = path, ext
        self.center_crop, self.random_crop = center_crop, random_crop
        self.resize, self.sampling = resize, sampling
        files = sorted(os.listdir(path))
        if sampling and sampling < len(files):
            files = list(np.random.default_rng(seed).choice(files, size=sampling, replace=False))
        self.files = files
        self._cache: dict = {}

    def __len__(self) -> int:
        return self.sampling if self.sampling else len(self.files)

    def _get(self, name: str) -> np.ndarray:
        if name not in self._cache:
            arr = _load_image(os.path.join(self.path, name), self.ext)
            if self.resize is not None:
                arr = _resize(arr, *self.resize)
            self._cache[name] = arr
        return self._cache[name]

    def _preprocessed(self, name: str) -> np.ndarray:
        """One image after the deterministic part of the pipeline: center
        crop and resize to 64^2 with ``center_crop``, else as decoded (and
        resized with ``resize``)."""
        arr = self._get(name)
        if self.center_crop:
            arr = _resize(_center_crop(arr, self.center_crop), 64, 64)
        return arr

    def sample_batch(self, rng: np.random.Generator, batch_size: int) -> np.ndarray:
        """A host batch (B, h, w, C) float32: a file per element drawn with
        ``rng``, then its random crop (without ``center_crop``)."""
        out = []
        for name in rng.choice(self.files, size=batch_size):
            arr = self._preprocessed(name)
            if not self.center_crop and self.random_crop:
                s = self.random_crop
                h, w = arr.shape[:2]
                top = int(rng.integers(0, h - s + 1))
                left = int(rng.integers(0, w - s + 1))
                arr = arr[top : top + s, left : left + s]
            out.append(arr)
        return _normalize_np(np.stack(out))

    def _stack_meta(self):
        """(h, w) per image after preprocessing, and the channels, read from
        the file headers (PIL's lazy ``open``) where no decoded image is
        cached: a directory over the device cap is found out without
        decoding it. Raises ValueError for mixed channel counts, a random
        crop larger than the smallest image, or sizes that differ with no
        crop to equalise them."""
        from PIL import Image

        hs, ws, chans = [], [], []
        for name in self.files:
            p = os.path.join(self.path, name)
            if name in self._cache or self.ext == "txt" or p.endswith(".txt"):
                h, w, c = self._preprocessed(name).shape
            else:
                with Image.open(p) as im:
                    w, h = im.size
                    c = 1 if im.mode == "L" else 3  # _load_image converts the rest to RGB
                if self.resize is not None:
                    h, w = self.resize
                if self.center_crop:
                    h = w = 64
            hs.append(h)
            ws.append(w)
            chans.append(c)
        hs, ws = np.asarray(hs, np.int32), np.asarray(ws, np.int32)
        if len(set(chans)) != 1:
            raise ValueError(f"images mix channel counts {sorted(set(chans))} — cannot stack "
                             "on device")
        crop = None if self.center_crop else self.random_crop
        if crop:
            if int(hs.min()) < crop or int(ws.min()) < crop:
                raise ValueError(f"--random_crop {crop} exceeds the smallest image "
                                 f"({int(hs.min())}x{int(ws.min())})")
        elif int(hs.min()) != int(hs.max()) or int(ws.min()) != int(ws.max()):
            raise ValueError("images differ in size and no crop equalizes them — cannot stack "
                             "on device")
        return hs, ws, chans[0]

    @property
    def img_ch(self) -> int:
        """The first image's channel count (a stack holds one count)."""
        return self._preprocessed(self.files[0]).shape[-1]

    def stacked_nbytes(self) -> int:
        """Bytes of the uint8 stack :meth:`stacked_images` would build
        (header-only; validates the stack)."""
        hs, ws, c = self._stack_meta()
        return len(self.files) * int(hs.max()) * int(ws.max()) * c

    def stacked_images(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every image in one (N, Hmax, Wmax, C) uint8 array, zero-padded to
        the largest extent on each axis, and each image's valid extent
        ``h_valid`` / ``w_valid`` (N,) int32."""
        self._stack_meta()  # validate before paying for the decode
        arrs = [self._preprocessed(n) for n in self.files]
        hs = np.array([a.shape[0] for a in arrs], np.int32)
        ws = np.array([a.shape[1] for a in arrs], np.int32)
        stacked = np.zeros((len(arrs), int(hs.max()), int(ws.max()), arrs[0].shape[-1]), np.uint8)
        for i, a in enumerate(arrs):
            stacked[i, : a.shape[0], : a.shape[1]] = a
        return stacked, hs, ws


def sample_multi_crops(imgs: torch.Tensor, h_valid: torch.Tensor, w_valid: torch.Tensor,
                       generator: torch.Generator, crop: int, batch: int) -> torch.Tensor:
    """A (batch, crop, crop, C) float32 batch from the padded stack ``imgs``
    (N, Hp, Wp, C) uint8: per element an image index, then a top and a left
    drawn inside THAT image's valid extent (``h_valid``, ``w_valid``, int64),
    in that order from ``generator``. Capturable in a CUDA graph."""
    dev = imgs.device
    idx = torch.randint(0, imgs.shape[0], (batch,), generator=generator, device=dev)
    tops = _randbelow(h_valid[idx] - (crop - 1), generator)
    lefts = _randbelow(w_valid[idx] - (crop - 1), generator)
    ar = torch.arange(crop, device=dev)
    rows = (tops[:, None] + ar)[:, :, None]
    cols = (lefts[:, None] + ar)[:, None, :]
    return normalize(imgs[idx[:, None, None], rows, cols])


def pick_images(imgs: torch.Tensor, generator: torch.Generator, batch: int) -> torch.Tensor:
    """A batch of whole images (the center-crop or resize datasets, whose
    preprocessing equalised them): an image index per element."""
    idx = torch.randint(0, imgs.shape[0], (batch,), generator=generator, device=imgs.device)
    return normalize(imgs[idx])


class DeviceMultiImageSampler:
    """Every (preprocessed) image on ``device`` once, as the padded stack
    ``imgs`` (N, Hmax, Wmax, C) uint8 with ``h_valid`` / ``w_valid`` (N,)
    int64; :meth:`sample` draws a batch there (:func:`sample_multi_crops`,
    or :func:`pick_images` without a random crop)."""

    #: the stack's device footprint above which :meth:`maybe_build` rotates windows
    MAX_DEVICE_MB = 1024.0

    def __init__(self, dataset: MultipleImagesDataset, device):
        stacked, hs, ws = dataset.stacked_images()
        self.imgs = torch.from_numpy(stacked).to(device)
        self.h_valid = torch.from_numpy(hs.astype(np.int64)).to(device)
        self.w_valid = torch.from_numpy(ws.astype(np.int64)).to(device)
        self.random_crop = None if dataset.center_crop else dataset.random_crop

    @classmethod
    def maybe_build(cls, dataset: MultipleImagesDataset, device, max_mb: Optional[float] = None,
                    batch_size: Optional[int] = None, seed: int = 0):
        """(sampler, None), or (None, reason) where the host
        :class:`Prefetcher` must serve: a stack over the cap (``max_mb``,
        default MAX_DEVICE_MB) gets a :class:`RotatingMultiImageSampler`
        (windows drawn from ``seed``) where a window of two or more images
        fits, else None. A stack that cannot be stacked raises ValueError,
        except at ``batch_size`` 1, where every host batch is one image."""
        try:
            stacked_mb = dataset.stacked_nbytes() / 2**20
        except ValueError as e:
            if batch_size == 1:
                return None, f"{e}; batch_size=1 host batches still work"
            raise
        limit = cls.MAX_DEVICE_MB if max_mb is None else max_mb
        if stacked_mb > limit:
            try:
                return RotatingMultiImageSampler(dataset, limit, device, seed=seed), None
            except ValueError as e:
                return None, (f"stacked dataset is {stacked_mb:.0f} MB on device (> {limit:.0f} "
                              f"MB cap) and no rotating subset fits ({e})")
        return cls(dataset, device), None

    def sample(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """``generator`` lives on the sampler's device."""
        if self.random_crop:
            return sample_multi_crops(self.imgs, self.h_valid, self.w_valid, generator,
                                      self.random_crop, batch_size)
        return pick_images(self.imgs, generator, batch_size)


class RotatingMultiImageSampler(DeviceMultiImageSampler):
    """A stack over the device cap: a window of ``subset_size`` images is
    resident and swapped at every dispatch chunk (:meth:`next_window`).

    Each epoch walks ``np.random.default_rng([seed, epoch]).permutation(n)``
    in windows of ``subset_size``, wrapping around, so every image is
    resident equally often (within one window) and a resumed epoch replays
    the same windows. Two windows are on the device, each with half the cap:
    ``imgs``, ``h_valid`` and ``w_valid``, the fixed storages that
    :meth:`sample` (and a step captured around it) reads, and the next
    window, whose host-to-device copy from pinned memory runs on a side
    stream while the current chunk computes; a swap waits for it (an event)
    and copies it into the fixed storages on the current stream."""

    def __init__(self, dataset: MultipleImagesDataset, cap_mb: float, device, seed: int = 0):
        stacked, hs, ws = dataset.stacked_images()
        n = stacked.shape[0]
        m = int(cap_mb * 2**20 / 2 // stacked[0].nbytes)
        if m < 2 or m >= n:
            raise ValueError(f"rotating subset needs 2 <= subset < n_images (cap {cap_mb:.0f} MB "
                             f"fits {m} of {n} padded images)")
        self.subset_size, self.n_images, self.seed = m, n, seed
        self.random_crop = None if dataset.center_crop else dataset.random_crop
        self._stack, self._hs, self._ws = stacked, hs.astype(np.int64), ws.astype(np.int64)
        device = torch.device(device)
        self._cuda = device.type == "cuda"
        shapes = ((m,) + stacked.shape[1:], (m,), (m,))
        dtypes = (torch.uint8, torch.int64, torch.int64)
        self.imgs, self.h_valid, self.w_valid = (
            torch.zeros(s, dtype=d, device=device) for s, d in zip(shapes, dtypes))
        self._next = [torch.zeros(s, dtype=d, device=device) for s, d in zip(shapes, dtypes)]
        self._host = [torch.zeros(s, dtype=d, pin_memory=self._cuda) for s, d in zip(shapes, dtypes)]
        if self._cuda:
            self._stream = torch.cuda.Stream(device)
            self._copied = torch.cuda.Event()  # the next window is on the device
            self._consumed = torch.cuda.Event()  # the last swap has read it
        self._order: Optional[np.ndarray] = None
        self._pos = 0
        self._staged: Optional[np.ndarray] = None
        self.window: Optional[np.ndarray] = None  # the resident window's image indices

    def _stage_next(self) -> None:
        idx = np.take(self._order, np.arange(self._pos, self._pos + self.subset_size), mode="wrap")
        self._pos = (self._pos + self.subset_size) % self.n_images
        self._staged = idx
        if self._cuda:
            self._copied.synchronize()  # the pinned buffers' last copy has left them
        for buf, src in zip(self._host, (self._stack, self._hs, self._ws)):
            np.take(src, idx, axis=0, out=buf.numpy())
        if not self._cuda:
            for dst, src in zip(self._next, self._host):
                dst.copy_(src)
            return
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(self._consumed)
            for dst, src in zip(self._next, self._host):
                dst.copy_(src, non_blocking=True)
            self._copied.record(self._stream)

    def prepare_epoch(self, epoch: int) -> None:
        """Start epoch ``epoch``'s walk: its permutation, and its first
        window staged."""
        self._order = np.random.default_rng([self.seed, epoch]).permutation(self.n_images)
        self._pos = 0
        self._stage_next()

    def next_window(self) -> np.ndarray:
        """Swap the staged window into the storages :meth:`sample` reads
        (after the chunk that read the last one, on the current stream),
        stage the following one, and return the new window's image
        indices."""
        if self._order is None:
            self.prepare_epoch(0)
        if self._cuda:
            torch.cuda.current_stream(self.imgs.device).wait_event(self._copied)
        for dst, src in zip((self.imgs, self.h_valid, self.w_valid), self._next):
            dst.copy_(src)
        if self._cuda:
            self._consumed.record(torch.cuda.current_stream(self.imgs.device))
        self.window = self._staged
        self._stage_next()
        return self.window


class Prefetcher:
    """A background thread that draws ``steps`` host batches
    (``dataset.sample_batch`` with ``np.random.default_rng(seed)``) and puts
    each on ``device``, from pinned memory on the card, into a queue of
    ``depth``; iterate to take them."""

    def __init__(self, dataset, batch_size: int, steps: int, seed, device, depth: int = 2):
        self.dataset, self.batch_size, self.steps = dataset, batch_size, steps
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(batch)
        if self.device.type != "cuda":
            return x.to(self.device)
        return x.pin_memory().to(self.device, non_blocking=True)

    def _put(self, item) -> bool:
        """A put that gives up once the consumer has stopped iterating."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        for _ in range(self.steps):
            if self._stop.is_set():
                return
            if not self._put(self._to_device(self.dataset.sample_batch(self.rng, self.batch_size))):
                return
        self._put(None)

    def close(self) -> None:
        """Stop the worker (safe mid-iteration) and wait for it."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=10)

    def __iter__(self) -> Iterator[torch.Tensor]:
        try:
            while True:
                item = self.q.get()
                if item is None:
                    return
                yield item
        finally:
            self.close()


class HostBatches:
    """The train step's sampler for the :class:`Prefetcher` path: each
    :meth:`sample` takes the epoch's next prefetched batch (the generator
    draws nothing). :meth:`start_epoch` starts a new prefetcher."""

    def __init__(self, dataset, batch_size: int, steps: int, device):
        self.dataset, self.batch_size, self.steps, self.device = dataset, batch_size, steps, device
        self._it: Optional[Iterator[torch.Tensor]] = None
        self._pf: Optional[Prefetcher] = None

    def start_epoch(self, seed) -> None:
        self.close()
        self._pf = Prefetcher(self.dataset, self.batch_size, self.steps, seed, self.device)
        self._it = iter(self._pf)

    def sample(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        del generator, batch_size
        return next(self._it)

    def close(self) -> None:
        if self._pf is not None:
            self._pf.close()
            self._pf = self._it = None


def prepare_data(args):
    """The dataset of ``--data`` (the reference's ``prepare_data``). Raises
    ValueError for ``--resize_h`` without ``--resize_w`` or the reverse."""
    resize = None
    rh, rw = getattr(args, "resize_h", None), getattr(args, "resize_w", None)
    if rh is not None or rw is not None:
        if rh is None or rw is None:
            raise ValueError(f"--resize_h {rh} --resize_w {rw}: give both or neither")
        resize = (rh, rw)
    if args.data == "single_image":
        return SingleImageDataset(args.data_path, args.data_ext, args.center_crop,
                                  args.random_crop, args.sampling)
    if args.data == "multiple_images":
        return MultipleImagesDataset(args.data_path, args.data_ext, args.center_crop,
                                     args.random_crop, resize, args.sampling)
    raise ValueError(f"no data named: {args.data}")
