"""Metric-gated int8 serving: the metric deltas of the int8 graph against the
float (bn_fold) serving graph on a trained model (``tools/quant_metric_gate.py``
of the JAX package, its protocol on the port).

``Trainer.serving_mode`` serves int8 by default for the ff_effnet family;
this gate is the evidence that int8 costs no quality on the port's kernels.
The metrics are the reference suite (eval/metrics.py): ordinal error (5k
pairs, seed 10), WHDR(tau=0.03), NDCG@200 (seed 69), and the depth edge
metrics (boundary, completeness).

Protocol:
  * trained weights (``train``: 5 epochs over 128 ``scenes`` at batch 8,
    K 5, RPI 100, info_score, through ``Trainer.resident_chain(8)``; or a
    weights.npz)
  * >= 100 held-out images (seed 123, never seen in training)
  * calibration on 2 batches of seed-7 images (the training distribution,
    disjoint from the evaluation set)
  * per-image metrics against gt for ``jit_predict("bn_fold")`` and
    ``jit_predict("quant")`` (K4 on the card); paired deltas, NaN pairs out

    python -m pldepth_torch.tools.quant_metric_gate <weights.npz|train> \\
        [--model ff_effnet] [--n 104] [--size 448] [--out results.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np

# The budget: int8 serving stays the default only if the quality loss on
# every gating metric stays inside these; an int8 result *better* than float
# passes at any size. Orientation: +1 = higher is worse, -1 = higher is
# better (the reference edge metric scores aligned edges ~1). ndcg_200 is
# advisory (reported, never gates): under the reference's both-sorted quirk
# it compares sorted value distributions, not rankings (eval/metrics.py).
BUDGET = {
    "ordinal_error": (0.002, +1),
    "whdr_003": (0.002, +1),
    "edge_boundary": (0.02, -1),
    "edge_completeness": (0.02, -1),
}
ADVISORY = {
    "ndcg_200": (0.005, -1),
}


def _make_ds(dataset, n, size, seed):
    """'scenes' (default): piecewise-smooth depth with occlusion boundaries
    (data/scenes.py), on which the edge metrics are defined; 'synthetic':
    the smooth fields."""
    from pldepth_torch.data import SceneDepthDataset, SyntheticDepthDataset

    factory = SceneDepthDataset if dataset == "scenes" else SyntheticDepthDataset
    return factory(n=n, image_size=size, seed=seed)


def _train(cfg_kwargs, dataset="scenes", epochs=5, seed=0, device=None):
    """The synthetic-convergence run in-process: ``epochs`` epochs over 128
    images through the resident store in chains of 8 steps."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data import build_resident_store
    from pldepth_torch.train import Trainer

    cfg = ExperimentConfig(
        epochs=epochs, batch_size=8, ds_size=128, initial_lr=0.01,
        ranking_size=5, rankings_per_image=100, sampling_type=1,
        data_resident=True, resident_chain_steps=8, **cfg_kwargs,
    )
    trainer = Trainer(cfg, steps_per_epoch=cfg.ds_size // cfg.batch_size, device=device)
    state = trainer.init_state()
    store = build_resident_store(_make_ds(dataset, cfg.ds_size, cfg.input_size, seed=seed),
                                 trainer.device)
    steps = cfg.epochs * (cfg.ds_size // cfg.batch_size)
    chain = trainer.resident_chain(cfg.resident_chain_steps)
    n_chains = steps // cfg.resident_chain_steps
    for i in range(n_chains):
        state, m = chain(state, store.arrays)
        if i % 2 == 1 and m.done is not None:
            m.done.synchronize()  # at most two chains in flight
        if i == 0 or i == n_chains - 1:
            print(f"# train chain {i}: loss {float(m.loss.float().mean()):.4f}", flush=True)
    return trainer, state


def image_metrics(pred: np.ndarray, gt: np.ndarray) -> Dict[str, float]:
    """One image's row: the gate's metrics of ``pred`` against ``gt``."""
    from pldepth_torch.eval.metrics import depth_edge_metric, ndcg_at_k, ordinal_error, whdr

    eb, ec = depth_edge_metric(pred, gt)
    return {
        "ordinal_error": ordinal_error(pred, gt),
        "whdr_003": whdr(pred, gt, tau=0.03),
        "ndcg_200": ndcg_at_k(pred, gt, 200),
        "edge_boundary": eb,
        "edge_completeness": ec,
    }


def summarize(rows: Dict[str, List[Dict[str, float]]]) -> Dict[str, dict]:
    """Per-image rows of both graphs (``{"float": [...], "int8": [...]}``,
    image j in place j of each) -> the metrics dict of the result.

    A metric is NaN on an image where auto-Canny finds no edges in one of
    the maps (0/0 in the reference formula, metrics.py:123-144); such pairs
    are left out, since the delta between graphs on the same images is what
    is gated. ``quality_loss`` = delta * orientation (positive: int8 is
    worse); ``pass`` = quality_loss <= budget."""
    out = {}
    for metric in {**BUDGET, **ADVISORY}:
        vf = np.array([r[metric] for r in rows["float"]], np.float64)
        vq = np.array([r[metric] for r in rows["int8"]], np.float64)
        valid = np.isfinite(vf) & np.isfinite(vq)
        n_valid = int(valid.sum())
        if n_valid == 0:
            out[metric] = {"n_valid": 0, "pass": True, "note": "no valid images"}
            continue
        mf = float(vf[valid].mean())
        mq = float(vq[valid].mean())
        delta = mq - mf
        per_img = vq[valid] - vf[valid]  # paired per-image deltas
        advisory = metric in ADVISORY
        budget, orient = (ADVISORY if advisory else BUDGET)[metric]
        quality_loss = delta * orient
        out[metric] = {
            "float": round(mf, 5), "int8": round(mq, 5),
            "delta": round(delta, 5),
            "quality_loss": round(quality_loss, 5), "budget": budget,
            "delta_abs_p95": round(float(np.percentile(np.abs(per_img), 95)), 5),
            "n_valid": n_valid,
            "pass": quality_loss <= budget,
            **({"advisory": True} if advisory else {}),
        }
    return out


def verdict(metrics: Dict[str, dict]) -> bool:
    """Pass unless a gating (non-advisory) metric fails its budget."""
    return all(m["pass"] for m in metrics.values() if not m.get("advisory"))


def run_gate(model="ff_effnet", size=448, n=104, batch=8, dataset="scenes",
             weights="train", train_epochs=5, save_weights="", device=None):
    """The full gate protocol on ``device`` (default ``cuda``); returns the
    result dict: model, size, n_images, dataset, weights, metrics, pass."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer

    if weights == "train":
        trainer, state = _train(dict(model_name=model, input_size=size),
                                dataset=dataset, epochs=train_epochs, device=device)
        if save_weights:
            from pldepth_torch.train.checkpoint import save_weights_npz

            save_weights_npz(save_weights, state)
            print(f"# trained weights saved to {save_weights}")
    else:
        from pldepth_torch.train.checkpoint import load_weights_npz

        cfg = ExperimentConfig(model_name=model, input_size=size, batch_size=batch,
                               ranking_size=5, rankings_per_image=100, sampling_type=1)
        trainer = Trainer(cfg, steps_per_epoch=1, device=device)
        state = load_weights_npz(weights, trainer.init_state())

    bs = batch
    n = (n // bs) * bs
    ds = _make_ds(dataset, n, size, seed=123)
    items = [ds[i] for i in range(n)]
    calib_ds = _make_ds(dataset, 2 * bs, size, seed=7)
    calib = [np.stack([calib_ds[i]["image"] for i in range(s, s + bs)])
             for s in range(0, 2 * bs, bs)]
    qstate = trainer.prepare_quant(state, calib)

    f_float = trainer.jit_predict(fused="bn_fold")
    f_quant = trainer.jit_predict(fused="quant")
    rows = {"float": [], "int8": []}
    for s in range(0, n, bs):
        chunk = np.stack([it["image"] for it in items[s: s + bs]])
        for name, pred in (("float", f_float(state, chunk)), ("int8", f_quant(qstate, chunk))):
            pred = np.asarray(pred, np.float32)
            rows[name] += [image_metrics(pred[j], items[s + j]["gt"])
                           for j in range(pred.shape[0])]
        print(f"# evaluated {s + bs}/{n}", flush=True)

    metrics = summarize(rows)
    return {"model": model, "size": size, "n_images": n, "dataset": dataset,
            "weights": weights, "metrics": metrics, "pass": verdict(metrics)}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pldepth_torch.tools.quant_metric_gate")
    ap.add_argument("weights", help="weights.npz path or 'train'")
    ap.add_argument("--model", default="ff_effnet")
    ap.add_argument("--n", type=int, default=104)
    ap.add_argument("--size", type=int, default=448)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dataset", default="scenes", choices=["scenes", "synthetic"])
    ap.add_argument("--train_epochs", type=int, default=5)
    ap.add_argument("--out", default="")
    ap.add_argument("--save_weights", default="",
                    help="with 'train': save the trained weights here for later reuse")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = run_gate(
        model=args.model, size=args.size, n=args.n, batch=args.batch,
        dataset=args.dataset, weights=args.weights,
        train_epochs=args.train_epochs, save_weights=args.save_weights, device=args.device,
    )
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
