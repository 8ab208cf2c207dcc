"""Host-side window prefetching for datasets larger than device memory.

Counterpart of ``latent_diffusion_planning_tpu/data/host_prefetch.py``.
The default data path puts the welded arrays on the device and draws a
batch with one indexed gather (``data/windows.DeviceDataset``). A dataset
that does not fit stays on the host (numpy arrays, ``np.load(...,
mmap_mode="r")`` memory maps for shards beyond RAM, or CPU tensors), and a
native engine assembles the batches: ``csrc/window_prefetch.cpp``, the JAX
package's source, whose worker threads gather windows with the clamped
semantics of ``DeviceDataset.gather`` into a ring of slots, so the host's
gathering overlaps the device's work. The same seed draws the same indices
as the JAX package's engine: it is the same C++ and the same generator.

The engine is built for the host at first use (``_build.host_library``,
into the git-ignored ``build/``); if it does not build, construction raises
with the compiler's message. There is no other path.

``next_batch`` copies a ready slot into the next of ``n_slots`` pinned host
buffers and, for a CUDA ``device``, starts a ``non_blocking`` copy of it to
the card; a pinned buffer is refilled only after its copy has finished. On
the CPU the batch is a copy of the buffer.
"""

from __future__ import annotations

import ctypes
from typing import Iterator

import numpy as np
import torch

from .. import resolve_device
from ..ops.kernels import _build
from .ingest import WeldedDemos

SOURCE = "window_prefetch.cpp"


def _load_lib() -> ctypes.CDLL:
    lib = _build.host_library(SOURCE)
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64]
    lib.wp_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                            ctypes.POINTER(ctypes.c_int64)]
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """True iff the engine builds and loads on this host (the build is
    cached by the source's hash, so a second probe is cheap)."""
    try:
        _load_lib()
        return True
    except (OSError, RuntimeError):
        return False


def _host_array(x) -> np.ndarray:
    """A C-contiguous host array of a numpy array, memory map or CPU
    tensor (a memory map that is contiguous stays mapped)."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError("HostPrefetcher reads host arrays, not "
                             f"{x.device} tensors")
        x = x.numpy()
    return x if x.flags["C_CONTIGUOUS"] else np.ascontiguousarray(x)


class HostPrefetcher:
    """Ring-buffered native batch sampler over (possibly memory-mapped) host
    arrays; batches arrive on ``device`` (None means the card)."""

    def __init__(self, welded: WeldedDemos, frame_stack: int, seq_length: int,
                 batch_size: int, *, n_slots: int = 4, n_threads: int = 2,
                 seed: int = 0, device: torch.device | str | None = None):
        self._lib = _load_lib()
        self._handle = None
        self.device = resolve_device(device)
        self.frame_stack = frame_stack
        self.seq_length = seq_length
        self.batch_size = batch_size
        self.obs_keys = tuple(welded.obs_keys)
        self.dataset_keys = tuple(welded.dataset_keys)
        self.keys = self.obs_keys + self.dataset_keys

        starts = np.asarray(welded.demo_starts, np.int64)
        lengths = np.asarray(welded.demo_lengths, np.int64)
        self._demo_start = np.repeat(starts, lengths).astype(np.int32)
        self._demo_end = np.repeat(starts + lengths, lengths).astype(np.int32)
        # kept referenced: the engine reads them for its whole life
        self._arrays = [_host_array(welded.arrays[k]) for k in self.keys]

        n_keys = len(self.keys)
        ptrs = (ctypes.c_void_p * n_keys)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self._arrays])
        row_bytes = (ctypes.c_int64 * n_keys)(
            *[int(a.strides[0]) for a in self._arrays])
        is_obs = (ctypes.c_uint8 * n_keys)(
            *[1 if k in self.obs_keys else 0 for k in self.keys])
        self._handle = self._lib.wp_create(
            n_keys, ptrs, row_bytes, is_obs, int(lengths.sum()),
            self._demo_start.ctypes.data_as(ctypes.c_void_p),
            self._demo_end.ctypes.data_as(ctypes.c_void_p),
            frame_stack, seq_length, batch_size, n_slots, n_threads, seed)

        window = frame_stack - 1 + seq_length
        pin = self.device.type == "cuda"
        self._slots = []
        for _ in range(n_slots):
            bufs = []
            for k, a in zip(self.keys, self._arrays):
                rows = window if k in self.obs_keys else seq_length
                t = torch.from_numpy(np.empty((batch_size, rows) + a.shape[1:],
                                              a.dtype))
                bufs.append(t.pin_memory() if pin else t)
            idx = torch.empty(batch_size, dtype=torch.int64)
            self._slots.append((bufs, idx.pin_memory() if pin else idx, None))
        self._next = 0

    def next_batch(self, return_indices: bool = False):
        """``{"obs": {k: (B, W, ...)}, <dataset key>: (B, S, ...)}`` on the
        device (and the sampled indices (B,) int64 on the host)."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        bufs, idx, copied = self._slots[i]
        if copied is not None:
            copied.synchronize()        # the buffer's last copy has landed
        out_ptrs = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
        self._lib.wp_next(self._handle, out_ptrs, ctypes.cast(
            idx.data_ptr(), ctypes.POINTER(ctypes.c_int64)))
        if self.device.type == "cuda":
            moved = [b.to(self.device, non_blocking=True) for b in bufs]
            event = torch.cuda.Event()
            event.record()
            self._slots[i] = (bufs, idx, event)
        else:
            moved = [b.clone() for b in bufs]
        batch: dict = {"obs": {}}
        for k, t in zip(self.keys, moved):
            if k in self.obs_keys:
                batch["obs"][k] = t
            else:
                batch[k] = t
        return (batch, idx.clone()) if return_indices else batch

    def iter_batches(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.wp_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
