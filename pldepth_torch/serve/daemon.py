"""Directory-watching serving daemon (``pldepth_tpu/serve/daemon.py``).

Watch a directory, run every new image through the depth forward, write
``<stem>_depth.npy`` (+ optional png preview) to the output directory. The
model source is a weights checkpoint (``cli serve --load_model_path``) or an
exported artifact (``cli serve --artifact``, :func:`artifact_infer`: no
model code is imported).

New files are picked up when their size is stable across two polls (a
half-written upload never reaches the device; in ``once`` mode the two scans
are ``poll_interval`` apart for the same reason) and their output does not
exist yet. Each poll's backlog runs through serve/pipeline.run_pipeline, so
decode, device compute and file writes overlap. A file that fails to decode
or infer is quarantined (logged, skipped on later polls) instead of killing
the daemon.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional, Sequence, Set, Tuple

import numpy as np

from pldepth_torch.serve.pipeline import (
    decode_image_chunk,
    depth_writer,
    run_pipeline,
    unique_stems,
)

log = logging.getLogger(__name__)

_EXTS = (".jpg", ".jpeg", ".png")


def _scan(watch_dir: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    try:
        for name in os.listdir(watch_dir):
            if name.lower().endswith(_EXTS):
                p = os.path.join(watch_dir, name)
                try:
                    if os.path.isfile(p):  # a directory named x.png is not ours
                        out[p] = os.stat(p).st_size
                except OSError:
                    pass  # vanished between listdir and stat
    except FileNotFoundError:
        pass
    return out


def serve_directory(
    watch_dir: str,
    out_dir: str,
    infer: Callable[[np.ndarray], np.ndarray],
    input_size: int,
    batch_size: int,
    *,
    pad_batch: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    save_png: bool = False,
    poll_interval: float = 0.5,
    once: bool = False,
    max_polls: Optional[int] = None,
) -> int:
    """Serve until interrupted (or one backlog pass with ``once=True``).

    ``infer`` maps a ``(batch_size, S, S, 3)`` float32 array to depth maps;
    ``pad_batch`` (optional) rounds a short tail chunk up to the dispatch
    batch. Returns the number of images processed. A file is processed when
    its size is unchanged since the previous poll, its output does not
    exist yet, and it has not failed before (quarantine).
    """
    os.makedirs(out_dir, exist_ok=True)

    def decode(chunk: Sequence[str]) -> np.ndarray:
        imgs = decode_image_chunk(chunk, input_size)
        return pad_batch(imgs) if pad_batch is not None else imgs

    def done(stems: Dict[str, str], f: str) -> bool:
        return os.path.exists(os.path.join(out_dir, f"{stems[f]}_depth.npy"))

    processed = 0
    failed: Set[str] = set()
    if once:
        prev_sizes = _scan(watch_dir)
        time.sleep(poll_interval)  # let in-flight uploads grow past the scan
    else:
        prev_sizes = {}
    polls = 0
    while True:
        sizes = _scan(watch_dir)
        stems = unique_stems(sorted(sizes))  # collision-stable per scan
        ready = sorted(f for f, sz in sizes.items()
                       if prev_sizes.get(f) == sz and f not in failed and not done(stems, f))
        prev_sizes = sizes
        if ready:
            write = depth_writer(out_dir, save_png, stems)
            chunks = [ready[s: s + batch_size] for s in range(0, len(ready), batch_size)]
            try:
                run_pipeline(chunks, decode, infer, write)
                processed += len(ready)
            except Exception:
                # isolate the poison file: retry one file at a time, keep
                # the good ones, quarantine the bad
                log.exception("batch failed; retrying per file")
                for f in ready:
                    if done(stems, f):
                        processed += 1  # landed before the batch failed
                        continue
                    try:
                        run_pipeline([[f]], decode, infer, write)
                        processed += 1
                    except Exception as e:
                        failed.add(f)
                        log.error("quarantined %s: %s", f, e)
            if failed:
                log.warning("%d file(s) in quarantine", len(failed))
            log.info("served %d images total", processed)
        polls += 1
        if once or (max_polls is not None and polls >= max_polls):
            return processed
        time.sleep(poll_interval)


def artifact_infer(path: str, device=None) -> Tuple[Callable[[np.ndarray], np.ndarray], dict]:
    """(callable, meta) from an exported artifact (serve/export.py, weights
    baked in) on ``device`` (default ``cuda``): host f32 image batches in,
    host (B, S, S) f32 depth maps out."""
    from pldepth_torch.serve.export import load_exported

    call, meta = load_exported(path, device)

    def infer(imgs: np.ndarray) -> np.ndarray:
        return call(np.asarray(imgs, np.float32)).cpu().numpy()

    return infer, meta
