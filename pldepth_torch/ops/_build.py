"""Build the port's CUDA kernels with ``nvcc`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``pldepth_torch/_kernels_build/<name>-<digest>.so`` (the digest covers
the source and the flags, so an edited source rebuilds). A plain C
interface builds in seconds; a source that includes PyTorch's headers
takes minutes. :func:`build` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each kernel library: {symbol: (restype, argtypes)}
SIGNATURES = {
    "fused_mbconv": {
        "fused_mbconv_infer": (_I, [_I] + [_P] * 18 + [_I] * 22 + [_P]),
    },
    "banded_mbconv": {
        "banded_mbconv_infer": (_I, [_I] + [_P] * 18 + [_I] * 16 + [_P]),
    },
    "listmle": {
        "listmle_fwd": (_I, [_P] * 3 + [_I] * 2 + [_P]),
        "listmle_bwd": (_I, [_P] * 4 + [_I] * 2 + [_P]),
    },
    "quant_matmul": {
        "quant_matmul": (_I, [_P] * 6 + [_I] * 6 + [_P]),
        "quant_conv2d": (_I, [_P] * 6 + [_I] * 14 + [_P]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    # the shared headers count too: an edited header rebuilds every kernel
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all nvcc processes
    started together. Returns {name: ptxas report} for the ones compiled
    now. Raises with nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- nvcc {name} (rc {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a reader never sees a partial .so
            reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The built library for ``name`` with its C signatures set (builds it
    first if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for sym, (res, args) in SIGNATURES[name].items():
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = res, args
        _loaded[name] = lib
    return lib
