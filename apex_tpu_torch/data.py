"""Data loading: native prefetching record loaders feeding the device,
and on-device image normalisation.

Port of ``apex_tpu/data.py``. A C++ background-prefetch loader over
binary record files (``csrc/host_runtime.cpp`` through
:mod:`apex_tpu_torch._native`) reads the next batch on its worker thread
while the current one trains; each batch lands as tensors on the
loader's ``device`` (None → CUDA).

File format: flat binary, one fixed-size record after another (tokens
for a language model, image + label records for vision). Token files are
headerless (interop with raw tokenizer ``.bin`` streams); image files
carry a 16-byte geometry header so the loader verifies H×W exactly. The
files are the JAX package's: for the same file, seed and backend the
batches are its batches, in its order.

The JAX loaders' ``mesh`` (a data-parallel global batch, each host
reading its process's shard) waits for the distributed slice of the
loaders' mesh (ROADMAP queue 1 item 4); a ``mesh`` other than None
raises here.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch import _native
from apex_tpu_torch._capabilities import resolve_device

native_available = _native.available
RecordLoader = _native.RecordLoader

_MESH = ("a mesh (the data-parallel global batch) is not supported by "
         "apex_tpu_torch yet: ROADMAP queue 1 item 4, multi-GPU "
         "parallelism (the distributed slice of the loaders' mesh)")


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


class TokenLoader:
    """Stream ``[batch, seq_len+1]`` token records as (tokens, targets),
    ``[batch, seq_len]`` each, on ``device``.

    The +1 column provides next-token targets without a wasted roll.
    """

    def __init__(self, path: str, seq_len: int, batch: int, *,
                 dtype=np.int32, mesh=None, seed: int = 0,
                 shuffle: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        if mesh is not None:
            raise ValueError(_MESH)
        self._seq = seq_len
        self._dev = resolve_device(device)
        self._loader = RecordLoader(
            path, (seq_len + 1,), dtype, batch, seed=seed, shuffle=shuffle)

    @property
    def num_records(self) -> int:
        return self._loader.num_records

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        while True:
            yield self.next()

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        rec = self._loader.next()
        return (_to_device(rec[:, :-1], self._dev),
                _to_device(rec[:, 1:], self._dev))

    def close(self) -> None:
        self._loader.close()


def write_token_file(path: str, tokens: np.ndarray, seq_len: int,
                     dtype=np.int32) -> int:
    """Chop a 1-D token stream into ``seq_len+1``-sized records and write
    the binary file :class:`TokenLoader` reads. Returns the record
    count."""
    tokens = np.asarray(tokens, dtype=dtype).reshape(-1)
    rec = seq_len + 1
    n = tokens.size // rec
    tokens[: n * rec].reshape(n, rec).tofile(path)
    return n


#: Image-file header: magic, version, H, W (little-endian u32 each)
_IMG_MAGIC = b"ATIM"
_IMG_VERSION = 1
_IMG_HEADER_BYTES = 16


class ImageLoader:
    """Stream ``([batch, H, W, 3] uint8, [batch] int32)`` image batches on
    ``device``.

    The file opens with a 16-byte geometry header (validated against
    ``image_size``); a record is ``H*W*3`` uint8 pixels followed by a
    little-endian int32 label. Pixels cross host→device as uint8 (a
    quarter of fp32's bytes); :func:`normalize_images` normalises them
    on the device.
    """

    def __init__(self, path: str, image_size: Tuple[int, int], batch: int,
                 *, mesh=None, seed: int = 0, shuffle: bool = True,
                 device: Optional[Union[str, torch.device]] = None):
        if mesh is not None:
            raise ValueError(_MESH)
        self._hw = (int(image_size[0]), int(image_size[1]))
        self._dev = resolve_device(device)
        with open(path, "rb") as f:
            header = f.read(_IMG_HEADER_BYTES)
        if len(header) < _IMG_HEADER_BYTES:
            raise ValueError(
                f"{path}: {len(header)} bytes is shorter than the "
                f"{_IMG_HEADER_BYTES}-byte header — file truncated?")
        if header[:4] != _IMG_MAGIC:
            raise ValueError(
                f"{path}: not an apex_tpu image file (missing "
                f"{_IMG_MAGIC!r} header — was it written by "
                f"write_image_file?)")
        version = int(np.frombuffer(header[4:8], "<u4")[0])
        if version != _IMG_VERSION:
            raise ValueError(
                f"{path}: image-file format version {version}, this "
                f"loader reads version {_IMG_VERSION}")
        h, w = np.frombuffer(header[8:16], "<u4")
        if (int(h), int(w)) != self._hw:
            raise ValueError(
                f"{path} stores {int(h)}x{int(w)} images, loader asked "
                f"for {self._hw[0]}x{self._hw[1]}")
        rec = self._hw[0] * self._hw[1] * 3 + 4
        size = os.path.getsize(path) - _IMG_HEADER_BYTES
        if size % rec:
            raise ValueError(
                f"{path}: {size} payload bytes is not a multiple of the "
                f"{rec}-byte record — file truncated?")
        self._loader = RecordLoader(
            path, (rec,), np.uint8, batch, seed=seed, shuffle=shuffle,
            header_bytes=_IMG_HEADER_BYTES)

    @property
    def num_records(self) -> int:
        return self._loader.num_records

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        while True:
            yield self.next()

    def next(self) -> Tuple[torch.Tensor, torch.Tensor]:
        rec = self._loader.next()
        h, w = self._hw
        images = rec[:, : h * w * 3].reshape(-1, h, w, 3)
        # the label slice is strided (one row a record): contiguous first
        labels = np.ascontiguousarray(
            rec[:, h * w * 3:]).view("<i4").reshape(-1)
        return _to_device(images, self._dev), _to_device(labels, self._dev)

    def close(self) -> None:
        self._loader.close()


def write_image_file(path: str, images: np.ndarray,
                     labels: np.ndarray) -> int:
    """Pack ``[n, H, W, 3]`` uint8 images + ``[n]`` int labels into the
    fixed-record binary file :class:`ImageLoader` reads (16-byte geometry
    header, then ``H*W*3 + 4``-byte records)."""
    images = np.ascontiguousarray(images, dtype=np.uint8)
    n, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"expected NHWC with 3 channels, got {images.shape}")
    labels = np.asarray(labels, dtype=np.int32).reshape(n)
    rec = np.empty((n, h * w * 3 + 4), dtype=np.uint8)
    rec[:, : h * w * 3] = images.reshape(n, -1)
    rec[:, h * w * 3:] = labels.astype("<i4")[:, None].view(np.uint8)
    with open(path, "wb") as f:
        f.write(_IMG_MAGIC)
        f.write(np.array([_IMG_VERSION, h, w], "<u4").tobytes())
        rec.tofile(f)
    return n


#: ImageNet channel statistics (the constants the reference example's
#: torchvision transform bakes in), for on-device normalisation
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor, dtype=torch.float32,
                     mean: Tuple[float, ...] = IMAGENET_MEAN,
                     std: Tuple[float, ...] = IMAGENET_STD) -> torch.Tensor:
    """uint8 NHWC → ``(x / 255 - mean) / std`` in ``dtype``, on the
    images' device."""
    x = images.to(dtype) / torch.tensor(255.0, dtype=dtype,
                                        device=images.device)
    m = torch.tensor(mean, dtype=dtype, device=images.device)
    s = torch.tensor(std, dtype=dtype, device=images.device)
    return (x - m) / s


__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "ImageLoader", "RecordLoader",
           "TokenLoader", "native_available", "normalize_images",
           "write_image_file", "write_token_file"]
