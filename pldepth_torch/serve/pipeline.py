"""Three-stage serving pipeline: host decode ∥ device compute ∥ host write.

Copy of ``pldepth_tpu/serve/pipeline.py``. A bounded decode pool reads
ahead ``prefetch`` batches; the main thread queues inference (a CUDA
forward returns before the device finishes) and only waits for batch *i-1*
while batch *i* is computing; a writer pool turns finished host arrays into
output files. ``decode``/``infer``/``write`` are callables, so the same
pipeline serves files -> depth maps (cli predict) or any other batch source.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Sequence

import numpy as np

__all__ = ["run_pipeline", "decode_image_chunk", "depth_writer", "unique_stems"]


def run_pipeline(
    items: Sequence[Any],
    decode: Callable[[Any], Any],
    infer: Callable[[Any], Any],
    write: Callable[[Any, np.ndarray], Any],
    *,
    prefetch: int = 3,
    writers: int = 2,
) -> int:
    """Run ``write(item, np.asarray(infer(decode(item))))`` for every item,
    overlapping the stages. Returns the number of items processed.

    ``infer`` runs on the caller's thread in item order; ``decode`` runs up
    to ``prefetch`` items ahead on a pool; ``write`` receives the host
    result on a writer pool. Exceptions from any stage propagate.
    """
    items = list(items)
    if not items:
        return 0
    with ThreadPoolExecutor(max(1, prefetch)) as dec_pool, ThreadPoolExecutor(
        max(1, writers)
    ) as wr_pool:
        dec_futs: Dict[int, Any] = {}

        def read_ahead(i: int) -> None:
            for j in range(i, min(i + max(1, prefetch), len(items))):
                if j not in dec_futs:
                    dec_futs[j] = dec_pool.submit(decode, items[j])

        write_futs: list = []
        max_queued_writes = 2 * max(1, writers)

        def flush(item: Any, out: Any) -> None:
            host = np.asarray(out)  # wait for the device result
            # bound the write queue: each queued future pins a host batch
            while len(write_futs) >= max_queued_writes:
                write_futs.pop(0).result()
            write_futs.append(wr_pool.submit(write, item, host))

        pending = None  # (item, in-flight device result)
        try:
            for i, item in enumerate(items):
                read_ahead(i)
                x = dec_futs.pop(i).result()
                out = infer(x)  # queued; do not wait yet
                if pending is not None:
                    flush(*pending)  # wait for i-1 while i computes
                pending = (item, out)
            flush(*pending)
            pending = None
        finally:
            # a decode/infer failure at item i must not discard item i-1's
            # already-computed result: land it before propagating
            propagating = sys.exc_info()[0] is not None
            if pending is not None:
                try:
                    flush(*pending)
                except Exception:
                    pass  # the original exception is the one to surface
            for f in write_futs:
                try:
                    f.result()  # surface writer exceptions
                except Exception:
                    if not propagating:
                        raise
    return len(items)


def decode_image_chunk(chunk: Sequence[str], input_size: int) -> np.ndarray:
    """Read + bilinear-resize a list of image files into one float32 [0,1]
    batch (the model input convention, data/io.py read_image)."""
    from pldepth_torch.data import io as dio

    return np.stack([
        dio.resize_bilinear(dio.read_image(f, 3), (input_size, input_size))
        for f in chunk
    ])


def unique_stems(files: Sequence[str]) -> Dict[str, str]:
    """Output-name stem per input file; same-stem inputs (a.jpg + a.png)
    get their extension folded in (``a_jpg``/``a_png``)."""
    stems: Dict[str, str] = {}
    counts: Dict[str, int] = {}
    for f in files:
        s = os.path.splitext(os.path.basename(f))[0]
        counts[s] = counts.get(s, 0) + 1
    for f in files:
        base = os.path.basename(f)
        s = os.path.splitext(base)[0]
        stems[f] = s if counts[s] == 1 else base.replace(".", "_")
    return stems


def depth_writer(out_dir: str, save_png: bool, stems: Dict[str, str]):
    """Writer stage: ``<stem>_depth.npy`` (+ minmax-normalized png preview)
    per image."""

    def write(chunk: Sequence[str], preds: np.ndarray) -> None:
        for f, d in zip(chunk, preds[: len(chunk)]):
            stem = stems[f]
            np.save(os.path.join(out_dir, f"{stem}_depth.npy"), d)
            if save_png:
                from PIL import Image

                lo, hi = float(d.min()), float(d.max())
                u8 = ((d - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
                Image.fromarray(u8).save(
                    os.path.join(out_dir, f"{stem}_depth.png")
                )

    return write
