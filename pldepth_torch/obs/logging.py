"""Run logging (``pldepth_tpu/obs/logging.py``): JSONL and CSV under
``<output_dir>/<run_name>/`` always, plus ``config.json``, ``summary.json``
and example PNGs under ``examples/``; forwarded to wandb, TensorBoard
(``torch.utils.tensorboard`` under ``<run>/tb``) and mlflow when the run asks
for them. Each sink's package is imported when the logger is made; a sink
that is asked for but cannot be set up logs a warning and the logger stays
local-only, as the JAX package's does. No API keys in code.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np

log = logging.getLogger(__name__)


class MetricLogger:
    def __init__(self, output_dir: str, run_name: str = "run",
                 config: Optional[Dict[str, Any]] = None, use_wandb: bool = False,
                 wandb_project: str = "pldepth-tpu", use_tensorboard: bool = False,
                 use_mlflow: bool = False, mlflow_tracking_uri: str = ""):
        self.dir = os.path.join(output_dir, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._csv_path = os.path.join(self.dir, "metrics.csv")
        self._csv_fields: Optional[list] = None
        self._csv_file = None
        self._wandb = None
        self._tb = None
        self._mlflow = None
        self.summary: Dict[str, Any] = {}
        if config:
            with open(os.path.join(self.dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)
        if use_wandb:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=wandb_project, name=run_name,
                                         config=config or {})
            except Exception as e:
                log.warning("wandb requested but unavailable (%s); local-only", e)
        if use_tensorboard:
            # the reference's third sink (tracking_utils.py:33-39)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=os.path.join(self.dir, "tb"))
            except Exception as e:
                log.warning("tensorboard requested but unavailable (%s)", e)
        if use_mlflow:
            # the reference's tracking-uri init (env.py:28-37) and param
            # logging (tracking_utils.py:8-10)
            try:
                import mlflow  # type: ignore

                if mlflow_tracking_uri:
                    mlflow.set_tracking_uri(mlflow_tracking_uri)
                mlflow.start_run(run_name=run_name)
                if config:
                    mlflow.log_params({k: str(v)[:500] for k, v in config.items()})
                self._mlflow = mlflow
            except Exception as e:
                log.warning("mlflow requested but unavailable (%s); local-only", e)

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        rec = {"_time": time.time(), **({"step": step} if step is not None else {}), **metrics}
        self._jsonl.write(json.dumps(rec, default=float) + "\n")
        self._jsonl.flush()
        self._write_csv(rec)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, global_step=step)
        if self._mlflow is not None:
            scalars = {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}
            if scalars:
                self._mlflow.log_metrics(scalars, step=step or 0)

    def _write_csv(self, rec: Dict[str, Any]):
        """A CSV row under a header that grows: new keys rewrite the file
        with the union header, keeping earlier rows (an existing file's
        header is adopted first, for --resume)."""
        if self._csv_fields is None and os.path.exists(self._csv_path):
            with open(self._csv_path, newline="") as f:
                first = f.readline().strip()
            self._csv_fields = first.split(",") if first else None
        fields = self._csv_fields or []
        new_keys = [k for k in rec if k not in fields]
        if new_keys:
            fields = fields + new_keys
            rows = []
            if self._csv_file is not None:
                self._csv_file.close()
            if os.path.exists(self._csv_path):
                with open(self._csv_path, newline="") as f:
                    rows = list(csv.DictReader(f))
            self._csv_file = open(self._csv_path, "w", newline="")
            self._csv = csv.DictWriter(self._csv_file, fieldnames=fields, extrasaction="ignore")
            self._csv.writeheader()
            for r in rows:
                self._csv.writerow(r)
            self._csv_fields = fields
        if self._csv_file is None:  # header already on disk (resume)
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv = csv.DictWriter(self._csv_file, fieldnames=self._csv_fields,
                                       extrasaction="ignore")
        self._csv.writerow({k: rec.get(k) for k in self._csv_fields})
        self._csv_file.flush()

    def set_summary(self, **kwargs):
        """wandb.run.summary equivalent (PLDepth.py:190-193): ``summary.json``,
        ``summary/<k>`` scalars to TensorBoard, ``summary_<k>`` to mlflow."""
        self.summary.update(kwargs)
        with open(os.path.join(self.dir, "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=2, default=float)
        if self._wandb is not None:
            for k, v in kwargs.items():
                self._wandb.summary[k] = v
        if self._tb is not None:
            for k, v in kwargs.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"summary/{k}", v)
        if self._mlflow is not None:
            scalars = {f"summary_{k}": float(v) for k, v in kwargs.items()
                       if isinstance(v, (int, float))}
            if scalars:
                self._mlflow.log_metrics(scalars)

    def log_images(self, images: Dict[str, Any], captions: Optional[Dict[str, str]] = None):
        """Example-image logging (reference PLDepth.py:196-209: input / gt /
        predicted depth at train end): PNGs under ``<run>/examples/``, and
        to wandb (with ``captions``) and TensorBoard (HWC u8) when active.
        Values: (H, W) float maps, min-max scaled to u8, or (H, W, 3)
        images in [0, 1], passed through. A PNG that cannot be written (no
        PIL) is logged as a warning and skipped."""
        ex_dir = os.path.join(self.dir, "examples")
        os.makedirs(ex_dir, exist_ok=True)
        captions = captions or {}
        for name, arr in images.items():
            a = np.squeeze(np.asarray(arr)).astype(np.float64)
            if a.ndim == 3:  # RGB in [0,1] passes through
                u8 = (a * 255.0).clip(0, 255).astype(np.uint8)
            else:  # grayscale maps are min-max scaled
                lo, hi = float(a.min()), float(a.max())
                u8 = np.zeros_like(a, np.uint8) if hi - lo < 1e-12 else (
                    (a - lo) * 255.0 / (hi - lo)).astype(np.uint8)
            try:
                from PIL import Image

                Image.fromarray(u8).save(os.path.join(ex_dir, f"{name}.png"))
            except (ImportError, OSError) as e:
                log.warning("could not write example image %s: %s", name, e)
            if self._wandb is not None:
                import wandb  # type: ignore

                self._wandb.log(
                    {name: wandb.Image(np.asarray(arr), caption=captions.get(name, name))})
            if self._tb is not None:
                self._tb.add_image(name, u8[..., None] if u8.ndim == 2 else u8,
                                   dataformats="HWC")

    def close(self):
        self._jsonl.close()
        if self._csv_file:
            self._csv_file.close()
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
        if self._mlflow is not None:
            self._mlflow.end_run()
