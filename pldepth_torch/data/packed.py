"""Packed-dataset format and its native reader (``pldepth_tpu/data/packed.py``).

Decode-once data path: any :class:`DepthDataset` is packed into one binary
file (u8 images, f32 gt, u8 mask; ``native/packio.cpp`` gives the layout),
then training streams batches through the C++ mmap reader with a background
prefetch ring: the only per-step host work is one copy out of the ring. The
format is the JAX package's, so a pack written by either package loads in
both.

The reader is ``native/packio.cpp``, the port's own copy, built with g++ at
first use into ``pldepth_torch/_kernels_build/packio-<digest>.so`` (the
digest covers the source and the flags). A failed build raises with the
compiler's output; unlike the JAX package there is no silent fallback.
:func:`PackedDataset` is a second reader (numpy memmap) that a caller
chooses, never a stand-in for the native one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.ops._build import BUILD_DIR

_MAGIC = b"PLDPACK1"
_HEADER = struct.Struct("<8sIIII")  # magic, version, n, h, w
SOURCE = Path(__file__).resolve().parent.parent / "native" / "packio.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_U32P = ctypes.POINTER(ctypes.c_uint32)
# C signature of each symbol: (restype, argtypes)
_SIGNATURES = {
    "packio_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "packio_close": (None, [ctypes.c_void_p]),
    "packio_info": (None, [ctypes.c_void_p, _U32P, _U32P, _U32P]),
    "packio_get_batch": (None, [ctypes.c_void_p, _U32P, ctypes.c_uint32, ctypes.c_int,
                                _F32P, _F32P, _F32P]),
    "packio_prefetch_start": (ctypes.c_void_p, [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_uint64]),
    "packio_prefetch_next": (ctypes.c_int, [ctypes.c_void_p, _F32P, _F32P, _F32P]),
    "packio_prefetch_next_u8": (ctypes.c_int, [ctypes.c_void_p, _U8P, _F32P, _U8P]),
    "packio_prefetch_stop": (None, [ctypes.c_void_p]),
}
_loaded: Dict[str, ctypes.CDLL] = {}


def _cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the packed reader (native/packio.cpp) needs it")
    return cxx


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"packio-{digest}.so"


def build_native() -> str:
    """Path of the built reader, compiling it first if needed. Raises with
    the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    r = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(SOURCE), "-lpthread"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"packio build failed (rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees a partial library
    return str(out)


def _load_lib() -> ctypes.CDLL:
    path = build_native()
    lib = _loaded.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        for sym, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = res, args
        _loaded[path] = lib
    return lib


def pack_dataset(ds: DepthDataset, path: str) -> str:
    """Write a DepthDataset into the packed format (decode-once)."""
    h, w = ds[0]["gt"].shape
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, 1, len(ds), h, w))
        for i in range(len(ds)):
            s = ds[i]
            # records are fixed-size: one deviant sample would shift every
            # later record (the reader's size check passes on a longer file)
            if s["gt"].shape != (h, w) or s["image"].shape != (h, w, 3):
                raise ValueError(
                    f"sample {i} has shape gt={s['gt'].shape} image={s['image'].shape}; "
                    f"expected ({h}, {w}) from sample 0 -- resize the dataset before packing")
            img = np.clip(s["image"] * 255.0 + 0.5, 0, 255).astype(np.uint8)
            f.write(img.tobytes())
            f.write(s["gt"].astype("<f4").tobytes())
            f.write((s["mask"] > 0).astype(np.uint8).tobytes())
    return path


def PackedDataset(path: str) -> DepthDataset:
    """DepthDataset view over a packed file (numpy memmap, no decode step):
    images f32 in [0, 1] (u8 / 255), gt f32, mask f32 0/1."""
    with open(path, "rb") as f:
        magic, version, n, h, w = _HEADER.unpack(f.read(_HEADER.size))
    if magic != _MAGIC or version != 1:
        raise ValueError(f"{path} is not a PLDPACK1 file")
    hw = h * w
    rec = hw * 3 + hw * 4 + hw
    raw = np.memmap(path, dtype=np.uint8, mode="r", offset=_HEADER.size)
    raw = raw[:n * rec].reshape(n, rec)

    def load(i: int) -> Dict[str, np.ndarray]:
        r = raw[i]
        img = r[:hw * 3].reshape(h, w, 3).astype(np.float32) / 255.0
        gt = r[hw * 3:hw * 3 + hw * 4].view("<f4").reshape(h, w).copy()
        mask = r[hw * 3 + hw * 4:].reshape(h, w).astype(np.float32)
        return {"image": img, "gt": gt, "mask": mask}

    return DepthDataset(name="packed", size=n, loader=load)


class NativePackedIterator:
    """Shuffled batch iterator backed by the C++ prefetch ring: a drop-in
    for data/pipeline.BatchIterator on packed files.

    ``uint8_wire`` (default on): images and masks as uint8, gt f32; the
    train step rescales on the device. ``start_step``: skip the first N
    batches of the deterministic stream (resume; skipped batches are never
    decoded). ``ring``: batches kept ready; ``workers``: decode threads."""

    def __init__(self, path: str, batch_size: int, seed: int = 0, shuffle: bool = True,
                 loop: bool = True, workers: Optional[int] = None, ring: int = 2,
                 uint8_wire: bool = True, start_step: int = 0):
        if workers is None:
            workers = max(1, (os.cpu_count() or 1) - 1)
        self.uint8_wire = uint8_wire
        self._lib = lib = _load_lib()
        self._pf = None
        self._h_reader = lib.packio_open(path.encode())
        if not self._h_reader:
            raise FileNotFoundError(f"cannot open packed file {path}")
        n, h, w = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        lib.packio_info(self._h_reader, ctypes.byref(n), ctypes.byref(h), ctypes.byref(w))
        self.n, self.h, self.w = n.value, h.value, w.value
        if batch_size < 1:
            self.close()
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if self.n < batch_size:
            self.close()
            raise ValueError(f"{self.n} records cannot fill batch {batch_size}")
        self.batch_size = batch_size
        self._pf = lib.packio_prefetch_start(self._h_reader, batch_size, seed, int(shuffle),
                                             int(loop), workers, ring, int(uint8_wire),
                                             int(start_step))

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if not self._pf:
            raise StopIteration
        # fresh arrays a batch: the ring copies into them once, and they
        # pass to the caller
        shape = (self.batch_size, self.h, self.w)
        gt = np.empty(shape, np.float32)
        wire = np.uint8 if self.uint8_wire else np.float32
        img, mask = np.empty(shape + (3,), wire), np.empty(shape, wire)
        next_fn, ptr = ((self._lib.packio_prefetch_next_u8, _U8P) if self.uint8_wire
                        else (self._lib.packio_prefetch_next, _F32P))
        if not next_fn(self._pf, img.ctypes.data_as(ptr), gt.ctypes.data_as(_F32P),
                       mask.ctypes.data_as(ptr)):
            raise StopIteration
        return {"image": img, "gt": gt, "mask": mask}

    def close(self):
        if getattr(self, "_pf", None):
            self._lib.packio_prefetch_stop(self._pf)
            self._pf = None
        if getattr(self, "_h_reader", None):
            self._lib.packio_close(self._h_reader)
            self._h_reader = None

    def __del__(self):
        self.close()
