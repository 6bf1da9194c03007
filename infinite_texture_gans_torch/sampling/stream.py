"""Streamed infinite-canvas generation: host memory O(one band), any size.

Port of ``infinite_texture_gans_tpu/sampling/stream.py``. ``generate_canvas``
holds the whole canvas on the device and then on the host; this engine
writes each group of canvas rows straight into a PNG instead:

* the raster scan is ``sampling/infinite.py: raster_bands`` (the same
  latents, halo cache and trim, so the pixels are ``generate_canvas(wire=
  'u8')``'s byte for byte; on the card a canvas row is one CUDA graph
  replay once its kind of row has come up twice);
* each band's kept uint8 rows start their device-to-host copy into a pinned
  host buffer at once (``non_blocking``, fenced by a CUDA event: the
  reference's ``copy_to_host_async``), and one encoder thread waits on the
  event and compresses the band while the main thread issues the next
  group, so the copy and the PNG encoding ride under the raster's issue
  and the device's work; the main thread waits for a band's encoding
  before it hands over the next, so at most two bands are on the host;
* the PNG is emitted incrementally: one IDAT chunk per band, filter 0, one
  zlib stream across the chunks, so the encoder holds O(band) too.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from infinite_texture_gans_torch.models.generator import ResidualPatchGenerator
from infinite_texture_gans_torch.sampling.infinite import canvas_latents, raster_bands


class StreamingPNGWriter:
    """Minimal incremental PNG encoder (8-bit RGB or grayscale, filter 0).

    Rows are compressed and flushed as successive IDAT chunks; PNG allows
    any number of them as long as their concatenation is one zlib stream."""

    def __init__(self, path: str, height: int, width: int, channels: int = 3,
                 compress_level: int = 1):
        if channels not in (1, 3):
            raise ValueError("StreamingPNGWriter supports 1 or 3 channels")
        self.path = path
        self.height = height
        self.width = width
        self.channels = channels
        self.rows_written = 0
        self._fh = open(path, "wb")
        self._z = zlib.compressobj(compress_level)
        self._fh.write(b"\x89PNG\r\n\x1a\n")
        color_type = 2 if channels == 3 else 0
        self._chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color_type, 0, 0, 0))

    def _chunk(self, tag: bytes, data: bytes) -> None:
        self._fh.write(struct.pack(">I", len(data)))
        self._fh.write(tag)
        self._fh.write(data)
        self._fh.write(struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    def write_rows(self, rows: np.ndarray) -> None:
        """rows: (n, >= width, channels) uint8; rows past the image's height
        and columns past its width are dropped."""
        take = min(rows.shape[0], self.height - self.rows_written)
        if take <= 0:
            return
        filtered = np.zeros((take, 1 + self.width * self.channels), np.uint8)
        filtered[:, 1:] = rows[:take, : self.width].reshape(take, -1)
        data = self._z.compress(filtered.tobytes())
        if data:
            self._chunk(b"IDAT", data)
        self.rows_written += take

    def close(self) -> None:
        if self._fh.closed:
            return
        if self.rows_written != self.height:
            raise ValueError(f"PNG closed early: {self.rows_written}/{self.height} rows")
        tail = self._z.flush()
        if tail:
            self._chunk(b"IDAT", tail)
        self._chunk(b"IEND", b"")
        self._fh.close()

    def abort(self) -> None:
        """Close the file and remove the partial PNG without the row-count
        check: for error paths, so the original exception is not masked and
        no truncated file is left behind."""
        if not self._fh.closed:
            self._fh.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


def read_png(path: str) -> np.ndarray:
    """Decode a PNG of :class:`StreamingPNGWriter`'s kind (8-bit RGB or
    grayscale, filter 0 on every row) with zlib alone, no image library:
    (H, W, C) uint8. The checks hold a streamed file to the in-memory
    canvas with it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr, tag = 8, [], None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n : pos + 12 + n])[0] != zlib.crc32(tag + body):
            raise ValueError(f"{path}: bad CRC in a {tag!r} chunk")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if ihdr is None or tag != b"IEND" or ihdr[2] != 8 or ihdr[3] not in (0, 2):
        raise ValueError(f"{path}: not an 8-bit RGB or grayscale PNG ending in IEND")
    w, h, c = ihdr[0], ihdr[1], 3 if ihdr[3] == 2 else 1
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, c)


@torch.no_grad()
def generate_canvas_streamed(
    gen: ResidualPatchGenerator,
    generator: Optional[torch.Generator],
    output_resolution_height: int,
    output_resolution_width: int,
    path: str,
    z_full: Optional[torch.Tensor] = None,
    maps_full: Optional[List[torch.Tensor]] = None,
    progress: bool = False,
    row_group: int = 4,
) -> str:
    """Raster-generate one canvas straight into the PNG at ``path``.

    The pixels equal ``generate_canvas(wire='u8')``'s from the same
    ``generator`` (or ``z_full`` / ``maps_full``) byte for byte; the host
    holds at most two bands of ``row_group`` canvas rows (the last canvas
    row is a group of its own). Returns ``path``."""
    (steps_h, steps_w, _, _), z_full, maps_full = canvas_latents(
        gen, generator, output_resolution_height, output_resolution_width, 1, z_full, maps_full)
    writer = StreamingPNGWriter(path, output_resolution_height, output_resolution_width,
                                gen.img_ch)

    def encode(r0: int, n: int, host: torch.Tensor, done: Optional[torch.cuda.Event]) -> None:
        if done is not None:
            done.synchronize()
        writer.write_rows(host[0].numpy())
        if progress:
            print(f"  rows {r0 + 1}-{r0 + n}/{steps_h} streamed", flush=True)

    encoder = ThreadPoolExecutor(max_workers=1)
    pending = None  # the band being encoded
    try:
        for r0, n, band in raster_bands(gen, z_full, maps_full, steps_h, steps_w, row_group,
                                        as_uint8=True):
            done = None
            if band.is_cuda:
                host = torch.empty(band.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(band, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host = band
            if pending is not None:
                pending.result()
            pending = encoder.submit(encode, r0, n, host, done)
        pending.result()
        writer.close()
    except BaseException:
        encoder.shutdown(wait=True, cancel_futures=True)
        writer.abort()
        raise
    finally:
        encoder.shutdown(wait=True)
    return path
