"""Sweep driver around the single Trainer (``pldepth_tpu/sweep/sweep.py``).

The reference had ~10 wandb sweep scripts and hyperopt-TPE harnesses, each
a copy of the trainer (pldepth/hyperopt/*, SURVEY.md §2). Here one driver
samples a search space (random, grid, or a numpy TPE step), runs short
experiments through the port's Trainer and reports the best config by the
target metric; ``run_wandb_sweep`` drives the same runs from a wandb sweep
server. The draws are the JAX package's: the same numpy Generator calls in
the same order.

Resumability: every finished run is appended to ``sweep_state.jsonl``, so
an interrupted sweep continues where it stopped (reference
hyperopt/restart_sweep.py and pickled Trials served this role). A run that
raises is recorded as ``{target: inf, "error": ...}`` and the sweep goes
on, as in the JAX package. Each run builds its own Trainer on ``device``
(``cuda`` unless the CPU is asked for); its model, optimizer state and
iterator are freed before the next run starts.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.core.device import DeviceLike, resolve_device
from pldepth_torch.sweep.search_spaces import SEARCH_SPACES

log = logging.getLogger(__name__)


def _sample(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    out = {}
    for k, spec in space.items():
        if "values" in spec:
            out[k] = spec["values"][int(rng.integers(len(spec["values"])))]
        elif spec.get("log"):
            out[k] = float(np.exp(rng.uniform(np.log(spec["min"]), np.log(spec["max"]))))
        else:
            out[k] = float(rng.uniform(spec["min"], spec["max"]))
    return out


def _sample_tpe(space: Dict[str, Any], history: list, target: str, rng: np.random.Generator,
                gamma: float = 0.25, n_candidates: int = 24) -> Dict[str, Any]:
    """Tree-structured Parzen Estimator step (the reference used hyperopt's
    TPE, pldepth/hyperopt/run.py:15-27). Below 4 scored observations it
    draws at random; otherwise it draws candidates from a kernel density
    over the good quantile and keeps the one maximizing the good/bad
    density ratio."""
    scored = [(h["overrides"], h["metrics"][target]) for h in history
              if np.isfinite(h["metrics"].get(target, np.inf))]
    if len(scored) < 4:
        return _sample(space, rng)
    scored.sort(key=lambda t: t[1])
    n_good = max(1, int(gamma * len(scored)))
    good = [s[0] for s in scored[:n_good]]
    bad = [s[0] for s in scored[n_good:]]

    def log_kde(values, x, spec):
        values = np.asarray(values, dtype=float)
        if "values" in spec:
            counts = np.sum(values == x) + 1.0
            return np.log(counts / (len(values) + len(spec["values"])))
        v = np.log(values) if spec.get("log") else values
        xq = np.log(x) if spec.get("log") else x
        bw = max(np.std(v), 1e-3 * (abs(np.mean(v)) + 1e-9))
        return float(np.log(np.mean(np.exp(-0.5 * ((xq - v) / bw) ** 2) / bw + 1e-12)))

    best_c, best_score = None, -np.inf
    for _ in range(n_candidates):
        cand = {}
        for k, spec in space.items():
            gv = [g[k] for g in good]
            if "values" in spec:
                # a draw from the smoothed histogram of the good runs
                opts = spec["values"]
                w = np.array([gv.count(o) + 1.0 for o in opts])
                cand[k] = opts[int(rng.choice(len(opts), p=w / w.sum()))]
            else:
                base = rng.choice(gv)
                v = np.log(base) if spec.get("log") else base
                sigma = max(np.std([np.log(x) if spec.get("log") else x for x in gv]),
                            1e-2 * (abs(v) + 1e-9))
                draw = rng.normal(v, sigma)
                draw = np.exp(draw) if spec.get("log") else draw
                cand[k] = float(np.clip(draw, spec["min"], spec["max"]))
        score = sum(log_kde([g[k] for g in good], cand[k], spec)
                    - log_kde([b[k] for b in bad], cand[k], spec)
                    for k, spec in space.items())
        if score > best_score:
            best_c, best_score = cand, score
    return best_c


def _grid(space: Dict[str, Any]):
    keys, vals = [], []
    for k, spec in space.items():
        if "values" not in spec:
            raise ValueError(f"grid search requires discrete values for {k}")
        keys.append(k)
        vals.append(spec["values"])
    for combo in itertools.product(*vals):
        yield dict(zip(keys, combo))


# metrics run_single can produce; anything else would make every record
# fail the finite-target filter after the full compute spend
SUPPORTED_TARGETS = ("loss", "test_error", "whdr")


def run_single(cfg: ExperimentConfig, target: str, device: DeviceLike = None) -> Dict[str, float]:
    """One short training run -> {"loss": ..., "test_error": ...} (and
    "whdr" for that target): ``Trainer.fit`` on the training split, then
    ``Evaluator.calc_err`` on up to 50 validation images."""
    from pldepth_torch.data.datasets import get_dataset
    from pldepth_torch.data.pipeline import BatchIterator, train_val_split
    from pldepth_torch.eval.evaluator import Evaluator
    from pldepth_torch.train.trainer import Trainer

    if cfg.dataset.lower() in ("hr-wsi", "hr_wsi", "hrwsi"):
        ds = get_dataset("HR-WSI", root=cfg.data_root, split="train", size=cfg.ds_size,
                         target_size=cfg.input_size)
    else:
        ds = get_dataset("synthetic", size=cfg.ds_size or 32, target_size=cfg.input_size,
                         seed=cfg.seed)
    train_ds, val_ds = train_val_split(ds, cfg.val_split_denom)
    trainer = Trainer(cfg, max(1, len(train_ds) // cfg.batch_size), device=device)
    state = trainer.init_state()
    it = BatchIterator(train_ds, cfg.batch_size, seed=cfg.seed)
    try:
        state, history = trainer.fit(state, it)
    finally:
        it.close()
    result = {"loss": history["loss"][-1]}
    if len(val_ds):
        ev = Evaluator(trainer, state)
        lim = min(50, len(val_ds))
        result["test_error"] = ev.calc_err(val_ds, limit=lim)
        if target == "whdr":
            result["whdr"] = ev.calc_err(val_ds, limit=lim, tau=0.03)
    return result


def _release(device: torch.device) -> None:
    """Free the finished run's model, optimizer state and iterator (the
    Trainer's cached closures hold it in reference cycles) and hand their
    device memory back, so a sweep's peak does not grow run by run."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_sweep(base_cfg: ExperimentConfig, num_runs: int = 8, search: str = "random",
              target: str = "test_error", space_name: str = "base",
              state_path: Optional[str] = None, device: DeviceLike = None) -> Dict[str, Any]:
    device = resolve_device(device)
    space = SEARCH_SPACES[space_name]
    if target not in SUPPORTED_TARGETS:
        raise ValueError(
            f"unknown sweep target {target!r}; run_single produces {SUPPORTED_TARGETS}")
    rng = np.random.default_rng(base_cfg.seed)
    state_path = state_path or os.path.join(base_cfg.output_dir, "sweep_state.jsonl")
    os.makedirs(os.path.dirname(state_path) or ".", exist_ok=True)

    done = []
    if os.path.exists(state_path):
        with open(state_path) as f:
            done = [json.loads(line) for line in f if line.strip()]
        log.info("resuming sweep: %d runs already recorded", len(done))

    if search == "grid":
        candidates = list(itertools.islice(_grid(space), num_runs))[len(done):]
        # a fully discrete space may have fewer combinations than num_runs
        num_runs = min(num_runs, len(done) + len(candidates))
    elif search == "random":
        # burn the draws already recorded, so that a resumed sweep continues
        # the seeded sequence instead of re-evaluating runs 1..len(done)
        for _ in range(len(done)):
            _sample(space, rng)
        candidates = [_sample(space, rng) for _ in range(num_runs - len(done))]
    elif search == "tpe":
        candidates = None  # drawn one by one from the history below
    else:
        raise ValueError(f"unknown search strategy {search!r}")

    results = list(done)
    with open(state_path, "a") as f:
        for i in range(len(done), num_runs):
            overrides = (_sample_tpe(space, results, target, rng) if search == "tpe"
                         else candidates[i - len(done)])
            cfg = base_cfg.replace(**overrides)
            log.info("sweep run %d/%d: %s", i + 1, num_runs, overrides)
            try:
                metrics = run_single(cfg, target, device)
            except Exception as e:  # the sweep goes on past a failed run
                log.exception("sweep run failed: %s", e)
                metrics = {target: float("inf"), "error": str(e)}
            _release(device)
            rec = {"overrides": overrides, "metrics": metrics}
            results.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()

    scored = [r for r in results if np.isfinite(r["metrics"].get(target, np.inf))]
    best = min(scored, key=lambda r: r["metrics"][target]) if scored else None
    return {"best": best, "num_runs": len(results)}


# ---------------------------------------------------------------------------
# wandb sweep backend (reference pldepth/hyperopt/sweep.py:12-46)
# ---------------------------------------------------------------------------


def space_to_wandb(space: Dict[str, Any], target: str) -> Dict[str, Any]:
    """A SEARCH_SPACES space as a wandb sweep config (the bayes-over-
    parameters shape of hyperopt/hyperparams.py:21-116)."""
    params: Dict[str, Any] = {}
    for k, spec in space.items():
        if "values" in spec:
            params[k] = {"values": list(spec["values"])}
        elif spec.get("log"):
            params[k] = {"distribution": "log_uniform_values",
                         "min": spec["min"], "max": spec["max"]}
        else:
            params[k] = {"distribution": "uniform", "min": spec["min"], "max": spec["max"]}
    return {"method": "bayes", "metric": {"name": target, "goal": "minimize"},
            "parameters": params}


def run_wandb_sweep(base_cfg: ExperimentConfig, num_runs: int = 8, target: str = "test_error",
                    space_name: str = "base", sweep_id: Optional[str] = None,
                    project: str = "pldepth-tpu-sweep", _wandb=None,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """Drive the search through a wandb sweep server (reference workflow:
    wandb.sweep + wandb.agent, hyperopt/sweep.py:12-46; re-attaching to an
    existing ``sweep_id`` is restart_sweep.py:11-45). Each agent call runs
    ``run_single`` and logs its metrics, so wandb's bayes optimizer steers
    the draws. ``_wandb`` injects the module (tests); by default the real
    package is imported."""
    device = resolve_device(device)
    wandb = _wandb
    if wandb is None:
        import wandb  # type: ignore  # noqa: F811

    if sweep_id is None:
        sweep_id = wandb.sweep(space_to_wandb(SEARCH_SPACES[space_name], target),
                               project=project)
        log.info("created wandb sweep %s", sweep_id)

    results: list = []

    def _one_run():
        run = wandb.init()
        # every suggested key that is a config field applies: on re-attach
        # to a sweep made from another space the server's draws must still
        # take effect, or the optimizer would see the base config's result
        # under different draws
        cfg_fields = {f.name for f in dataclasses.fields(base_cfg)}
        space = SEARCH_SPACES[space_name]
        suggested = dict(run.config)
        overrides = {k: v for k, v in suggested.items() if k in space or k in cfg_fields}
        unknown = sorted(set(suggested) - set(overrides))
        if unknown:
            log.warning("wandb sweep suggested parameters with no matching config field "
                        "(space mismatch on re-attach?): %s", unknown)
        cfg = base_cfg.replace(**overrides)
        try:
            metrics = run_single(cfg, target, device)
        except Exception as e:  # the agent goes on past a failed run
            log.exception("wandb sweep run failed: %s", e)
            metrics = {target: float("inf"), "error": str(e)}
        _release(device)
        wandb.log({k: v for k, v in metrics.items() if k != "error"})
        results.append({"overrides": overrides, "metrics": metrics})
        run.finish()

    wandb.agent(sweep_id, function=_one_run, count=num_runs, project=project)
    scored = [r for r in results if np.isfinite(r["metrics"].get(target, np.inf))]
    best = min(scored, key=lambda r: r["metrics"][target]) if scored else None
    return {"best": best, "num_runs": len(results), "sweep_id": sweep_id}
