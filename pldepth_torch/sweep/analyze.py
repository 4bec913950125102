"""Sweep trial analysis (``pldepth_tpu/sweep/analyze.py``).

Rebuild of the reference's HyperoptAnalyser
(pldepth/bk-hyperopt/trials_visualize.py:10-40: parameter-vs-loss plots and
best-trial extraction) over the ``sweep_state.jsonl`` that sweep/sweep.py
writes. matplotlib is imported by the plot function alone (Agg backend).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np


def load_trials(state_path: str) -> List[dict]:
    with open(state_path) as f:
        return [json.loads(line) for line in f if line.strip()]


def best_trial(trials: List[dict], target: str = "test_error") -> Optional[dict]:
    scored = [t for t in trials if np.isfinite(t["metrics"].get(target, np.inf))]
    return min(scored, key=lambda t: t["metrics"][target]) if scored else None


def param_table(trials: List[dict], target: str = "test_error") -> Dict[str, list]:
    """param name -> [(value, metric)] pairs for plotting / inspection."""
    table: Dict[str, list] = {}
    for t in trials:
        m = t["metrics"].get(target)
        if m is None or not np.isfinite(m):
            continue
        for k, v in t["overrides"].items():
            table.setdefault(k, []).append((v, m))
    return table


def plot_param_vs_metric(state_path: str, out_dir: str,
                         target: str = "test_error") -> List[str]:
    """One scatter per swept parameter (HyperoptAnalyser's plots); returns
    the PNG paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table = param_table(load_trials(state_path), target)
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for param, pairs in table.items():
        xs = [p[0] for p in pairs]
        ys = [p[1] for p in pairs]
        fig, ax = plt.subplots(figsize=(5, 3.5))
        ax.scatter(xs, ys, s=18)
        ax.set_xlabel(param)
        ax.set_ylabel(target)
        if all(isinstance(x, (int, float)) and x > 0 for x in xs) and (
                max(xs) / max(min(xs), 1e-12) > 30):
            ax.set_xscale("log")
        fig.tight_layout()
        path = os.path.join(out_dir, f"{param}_vs_{target}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        paths.append(path)
    return paths
