"""Command line of the port: ``python -m pldepth_torch.cli
train|eval|zeroshot|predict|serve|export|active|dump|chi2|analyze|convert|warmup|sweep ...``.

The thirteen commands of ``pldepth_tpu/cli.py`` with the same flag names,
defaults and ``true``/``false`` booleans, written with argparse, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels) on every command that runs the model.
``train`` runs ``Trainer.fit`` on one of three feeds (``--data_resident``:
the set held on the card; ``--pack_cache``: a packed file through the
native reader; else ``BatchIterator``, optionally ``--uint8_wire``), saves
``weights.npz`` and evaluates the trained weights on up to 250 validation
images (``summary.json``, an example image, and with ``--parity_report
true`` the verdict of
docs/PARITY.md in ``parity_report.json``); ``--profile true`` traces three
steady steps of ``fit`` with the program's spans (obs/profiling.py,
obs/spans.py), and the wandb, TensorBoard and mlflow sinks follow
``--use_*`` (obs/logging.py). ``eval`` is the
test-set report, ``zeroshot`` the cross-dataset suite (Ibims, DIODE,
Sintel, TUM, DIW).
``predict --profile_dir DIR`` traces the whole serving loop with its spans
into DIR. ``predict`` and ``serve`` with their default flags serve the int8
graph of the ff_effnet family (dense convs on K4, ops/quant_matmul.py), calibrated
on the first input batch(es), and the BN-folded graph of ff_redweb;
``export`` writes the float forward with its weights to one artifact
(serve/export.py) that ``serve --artifact`` runs without model code.
``active`` runs the active-learning rounds (active/loop.py) after loading
or pretraining weights, ``dump`` writes sampled (image, rankings) data
(data/offline.py), ``chi2`` the samplers' chi^2 diagnostic
(diagnostics/chi2.py). ``sweep`` runs a random / grid / TPE search (or a
wandb sweep) of short training runs with ``sweep_state.jsonl`` resume
(sweep/sweep.py), ``analyze`` reads that file back (sweep/analyze.py),
``convert`` maps Keras weights to the flat npz and back (models/convert.py;
needs TensorFlow) and ``warmup`` builds the kernels and runs each graph of
a config once.
Options the port does not run yet raise NotImplementedError naming their
ROADMAP item.

Under ``torchrun --nproc_per_node N`` (``WORLD_SIZE`` > 1) ``train``,
``active`` and ``warmup`` join the process group first (core/mesh.py:
NCCL with a card per rank, gloo when ranks share a card or run on the
CPU). ``train`` then feeds each rank its stride of the data (the streaming
feed's ``batch_size`` is per rank, the resident store's the global batch),
and rank 0 alone writes the run directory and runs the post-train report.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob as globmod
import json
import logging
import os
import sys
import time
from typing import List, Optional

log = logging.getLogger(__name__)

_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}


def _bool(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"{s!r} is not a valid boolean")


_MODELS = ["ff_redweb", "ff_effnet", "ff_effnet_b1", "ff_effnet_b2", "ff_effnet_b3",
           "ff_effnet_b4", "ff_effnet_b5", "ff_effnet_b6", "ff_effnet_b7", "ff_smoke"]


def _add_train_options(tr: argparse.ArgumentParser) -> None:
    """The reference flag set (pldepth/PLDepth.py:28-46) and the JAX
    package's extensions, names and defaults as in ``pldepth_tpu/cli.py``."""
    a = tr.add_argument
    # any case resolves to the listed name, as click.Choice(case_sensitive=False)
    a("--model_name", default="ff_effnet", type=str.lower, choices=_MODELS)
    a("--epochs", default=50, type=int)
    a("--batch_size", default=4, type=int)
    a("--seed", default=0, type=int)
    a("--ranking_size", default=3, type=int)
    a("--rankings_per_image", default=100, type=int)
    a("--initial_lr", default=0.01, type=float)
    a("--equality_threshold", default=0.03, type=float)
    a("--model_checkpoints", default=False, type=_bool)
    a("--load_model_path", default="")
    a("--augmentation", default=True, type=_bool)
    a("--warmup", default=0, type=int)
    a("--sampling_type", default=1, type=int,
      help="0=thresholded 1=info_score 2=masked 3=purely_masked 4=segment")
    a("--lr_multi", default=0.25, type=float)
    a("--ds_size", default=None, type=int)
    a("--dataset", default="synthetic",
      help="HR-WSI | synthetic (IBIMS | DIODE | SINTEL | TUM are test-only)")
    a("--data_root", default="")
    a("--input_size", default=224, type=int)
    a("--schedule", default="sgdr", choices=["sgdr", "step", "constant"])
    a("--freeze_encoder", default=False, type=_bool)
    a("--pretrained_path", default="")
    a("--compute_dtype", default="bfloat16")
    a("--sparse_tail", default=False, type=_bool)
    a("--fused_tail", default=True, type=_bool)
    a("--qres", default="", choices=["", "int8", "bf16"])
    a("--qenc", default="", choices=["", "bf16", "int8"])
    a("--decoder_head_ch", default=32, type=int)
    a("--output_dir", default="runs")
    a("--use_wandb", default=False, type=_bool)
    a("--use_tensorboard", default=False, type=_bool)
    a("--use_mlflow", default=False, type=_bool)
    a("--mlflow_tracking_uri", default="")
    a("--profile", default=False, type=_bool)
    a("--pack_cache", default="")
    a("--uint8_wire", default=False, type=_bool)
    a("--data_resident", default=False, type=_bool)
    a("--resident_chain_steps", default=1, type=int)
    a("--parity_report", default=False, type=_bool)
    a("--parity_target_whdr", default=-1.0, type=float)
    a("--parity_budget", default=0.005, type=float)
    a("--config_json", default="",
      help="JSON file with config values: the file wins over defaults, flags over the file")
    a("--mesh_model", default=1, type=int)
    a("--spatial_sharding", default=False, type=_bool)
    a("--run_name", default="", help="run directory under --output_dir (default: timestamped)")
    a("--resume", default=False, type=_bool,
      help="continue from the latest full-state checkpoint of --run_name")
    a("--device", default="cuda", help="cuda (default) or cpu")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pldepth_torch")
    sub = p.add_subparsers(dest="command", required=True)
    _add_train_options(sub.add_parser("train", help="the main training experiment"))
    ac = sub.add_parser("active", help="active learning (reference "
                                       "run_scripts/active_PLDepth.py:160-185)")
    _add_train_options(ac)
    ac.add_argument("--rounds", default=6, type=int)
    ac.add_argument("--split_num", default=32, type=int)
    ac.add_argument("--sigma", default=1.8, type=float)
    ac.add_argument("--pretrain_epochs", default=0, type=int)
    du = sub.add_parser("dump", help="offline (image, rankings) dump "
                                     "(reference active_learning/offline_data.py)")
    _add_train_options(du)
    du.add_argument("--out_dir", required=True)
    du.add_argument("--image_format", default="jpg", choices=["jpg", "npz"])
    ch = sub.add_parser("chi2", help="sampling chi^2 diagnostic (reference chi2compare.py)")
    _add_train_options(ch)
    ch.add_argument("--trials", default=5, type=int)
    ch.add_argument("--batches_per_trial", default=25, type=int)
    ev = sub.add_parser("eval", help="test-set evaluation (reference test_data_eval.py)")
    ev.add_argument("--model_name", default="ff_effnet")
    ev.add_argument("--load_model_path", required=True)
    ev.add_argument("--dataset", default="HR-WSI")
    ev.add_argument("--data_root", default="")
    ev.add_argument("--input_size", default=224, type=int)
    ev.add_argument("--ranking_size", default=5, type=int)
    ev.add_argument("--limit", default=None, type=int)
    ev.add_argument("--tau", default=0.03, type=float)
    ev.add_argument("--device_metrics", default=False, type=_bool,
                    help="compute ordinal/WHDR/NDCG on the device (statistically "
                         "equivalent, excludes edge metrics)")
    ev.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    zs = sub.add_parser("zeroshot", help="zero-shot cross-dataset ordinal suite")
    zs.add_argument("--model_name", default="ff_effnet")
    zs.add_argument("--load_model_path", required=True)
    zs.add_argument("--input_size", default=224, type=int)
    zs.add_argument("--limit", default=None, type=int)
    for root in ("ibims", "diode", "sintel", "tum"):
        zs.add_argument(f"--{root}_root", default="")
    zs.add_argument("--diw_root", default="",
                    help="DIW root: official layout, DIW_test.csv + images "
                         "(human ordinal pairs -> diw_whdr; data/diw.py)")
    zs.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    pr = sub.add_parser("predict", help="batched depth-map inference (serving path)")
    pr.add_argument("--model_name", default="ff_effnet")
    pr.add_argument("--load_model_path", required=True)
    pr.add_argument("--inputs", required=True,
                    help="image file or directory of images")
    pr.add_argument("--out_dir", required=True)
    pr.add_argument("--input_size", default=448, type=int)
    pr.add_argument("--batch_size", default=8, type=int)
    pr.add_argument("--save_png", default=True, type=_bool)
    _add_serving_mode_options(pr, "activation scales calibrate on the first input batch")
    pr.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    pr.add_argument("--profile_dir", default="",
                    help="write a torch.profiler Chrome trace of the serving loop, with "
                         "its spans (serve.queue, serve.infer, upload, serve.wait, "
                         "serve.write_wait), into this directory")
    sv = sub.add_parser("serve", help="serving daemon: watch a directory, write depth maps")
    sv.add_argument("--model_name", default="ff_effnet")
    sv.add_argument("--load_model_path", default="", help="weights .npz (live model source)")
    sv.add_argument("--artifact", default="",
                    help="exported .plx artifact (cli export; served without model code: "
                         "input_size and the batch come from its metadata)")
    sv.add_argument("--watch_dir", required=True)
    sv.add_argument("--out_dir", required=True)
    sv.add_argument("--input_size", default=448, type=int)
    sv.add_argument("--batch_size", default=8, type=int)
    sv.add_argument("--save_png", default=False, type=_bool)
    sv.add_argument("--poll_interval", default=0.5, type=float)
    sv.add_argument("--once", default=False, type=_bool,
                    help="process the current backlog and exit")
    _add_serving_mode_options(sv, "scales calibrate over the first dispatched batches")
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ex = sub.add_parser("export", help="write the inference forward, weights baked in, "
                                       "to a torch.export artifact (serve/export.py)")
    ex.add_argument("--model_name", default="ff_effnet")
    ex.add_argument("--load_model_path", required=True)
    ex.add_argument("--out", required=True, help="output artifact path (.plx)")
    ex.add_argument("--input_size", default=448, type=int)
    ex.add_argument("--batch_size", default=8, type=int,
                    help="fixed serving batch; 0 = batch-polymorphic artifact "
                         "(any batch at call time)")
    ex.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated devices the artifact may be loaded on")
    ex.add_argument("--bn_fold", default=True, type=_bool,
                    help="bake BN-folded weights into the artifact (models/bn_fold.py)")
    ex.add_argument("--device", default="cuda", help="cuda (default) or cpu: where the "
                                                     "graph is traced")
    an = sub.add_parser("analyze", help="sweep analysis: best trial and param-vs-metric plots "
                                        "(reference bk-hyperopt/trials_visualize.py)")
    an.add_argument("--state_path", required=True, help="sweep_state.jsonl")
    an.add_argument("--out_dir", default="sweep_plots")
    an.add_argument("--target", default="test_error")
    cv = sub.add_parser("convert", help="Keras weights -> the npz of --pretrained_path, or "
                                        "with --reverse a weights npz -> Keras .h5 (TensorFlow)")
    cv.add_argument("--weights", required=True,
                    help="Keras model file (.h5 / SavedModel dir) holding the backbone -- or, "
                         "with --reverse, a weights .npz of this package")
    cv.add_argument("--model_name", default="ff_effnet",
                    help="target family: ff_effnet* (EfficientNet) or ff_redweb (ResNet-50)")
    cv.add_argument("--out", required=True,
                    help="output .npz for --pretrained_path (or .h5 with --reverse)")
    cv.add_argument("--reverse", action="store_true", default=False,
                    help="export the other way: weights .npz -> Keras .h5")
    cv.add_argument("--template", default="",
                    help="(--reverse) existing Keras .h5 with the target architecture to "
                         "fill; without it a bare keras.applications backbone is built "
                         "and filled encoder-only")
    cv.add_argument("--input_size", default=448, type=int,
                    help="(--reverse, no template) input size of the built backbone")
    wu = sub.add_parser("warmup", help="build the kernels and run each graph of a config once")
    _add_train_options(wu)
    wu.add_argument("--serve_batch", default=0, type=int,
                    help="also run the serving graphs (predict + bn_fold) at this batch "
                         "size; 0 = training only")
    sw = sub.add_parser("sweep", help="hyperparameter sweep (reference "
                                      "pldepth/hyperopt/sweep.py adapters)")
    _add_train_options(sw)
    sw.add_argument("--num_runs", default=8, type=int)
    sw.add_argument("--search", default="random", choices=["random", "grid", "tpe", "wandb"])
    sw.add_argument("--target", default="test_error")
    sw.add_argument("--space", dest="space_name", default="base",
                    help="search space name (sweep/search_spaces.py)")
    sw.add_argument("--sweep_id", default=None,
                    help="wandb backend: re-attach an agent to an existing sweep "
                         "(reference hyperopt/restart_sweep.py)")
    return p


def _add_serving_mode_options(p: argparse.ArgumentParser, calib: str) -> None:
    p.add_argument("--fused_encoder", default=False, type=_bool,
                   help="run every encoder MBConv block on the fused kernel "
                        "(ff_effnet family)")
    p.add_argument("--bn_fold", default=True, type=_bool,
                   help="fold batch-norms into biased convs for serving "
                        "(models/bn_fold.py); --fused_encoder takes precedence")
    p.add_argument("--quantize", default="auto", choices=["auto", "", "int8"],
                   help="int8 serving (models/quantize.py, dense convs on K4); "
                        "'auto' = int8 for the ff_effnet family unless "
                        "--fused_encoder/--bn_fold override; '' = the float "
                        f"bn_fold graph; {calib}")


def _loaded_trainer(args: argparse.Namespace, **cfg_values):
    """(trainer, state) with the weights of ``--load_model_path``."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train.checkpoint import infer_decoder_head_ch, load_weights_npz
    from pldepth_torch.train.trainer import Trainer

    cfg = ExperimentConfig(
        model_name=args.model_name, input_size=args.input_size,
        decoder_head_ch=infer_decoder_head_ch(args.load_model_path), **cfg_values,
    )
    trainer = Trainer(cfg, steps_per_epoch=1, device=args.device)
    return trainer, load_weights_npz(args.load_model_path, trainer.init_state())


def _serving_trainer(args: argparse.Namespace):
    """(trainer, state, serving mode) from the weights of ``--load_model_path``."""
    from pldepth_torch.train.trainer import Trainer

    mode = Trainer.serving_mode(args.fused_encoder, args.bn_fold, args.quantize,
                                model_name=args.model_name)
    trainer, state = _loaded_trainer(args)
    return trainer, state, mode


def eval_cmd(args: argparse.Namespace) -> dict:
    """Test-set evaluation (reference test_data_eval.py:30-104)."""
    from pldepth_torch.data.datasets import get_dataset
    from pldepth_torch.eval.evaluator import Evaluator

    trainer, state = _loaded_trainer(args, ranking_size=args.ranking_size,
                                     dataset=args.dataset, data_root=args.data_root)
    if args.dataset.lower() == "synthetic":
        ds = get_dataset("synthetic", target_size=args.input_size, size=args.limit or 64)
    else:
        ds = get_dataset(args.dataset, root=args.data_root, target_size=args.input_size)
    ev = Evaluator(trainer, state)
    if args.device_metrics:
        return ev.full_report_device(ds, limit=args.limit, tau=args.tau)
    return ev.full_report(ds, limit=args.limit, tau=args.tau)


def zeroshot(args: argparse.Namespace) -> dict:
    """Zero-shot cross-dataset ordinal suite (BASELINE.json config #4):
    dense sets (Ibims/DIODE/Sintel/TUM) through the metric suite, DIW
    through human-pair WHDR (eval/diw.py documents the conventions)."""
    from pldepth_torch.data.datasets import get_dataset
    from pldepth_torch.eval.evaluator import Evaluator

    roots = [(name, getattr(args, f"{name.lower()}_root"))
             for name in ("IBIMS", "DIODE", "SINTEL", "TUM")]
    if not any(root for _, root in roots) and not args.diw_root:
        _parser().error("zeroshot: provide at least one dataset root")
    trainer, state = _loaded_trainer(args)
    datasets = [get_dataset(name, root=root, target_size=args.input_size)
                for name, root in roots if root]
    out = {}
    if datasets:
        out = Evaluator(trainer, state).zero_shot_suite(datasets, limit=args.limit)
    if args.diw_root:
        from pldepth_torch.data.diw import load_diw
        from pldepth_torch.eval.diw import evaluate_diw

        items = load_diw(args.diw_root)
        if args.limit:
            items = items[: args.limit]
        out["diw"] = evaluate_diw(trainer, state, items, args.input_size)
    return out


def predict(args: argparse.Namespace) -> dict:
    """Writes <name>_depth.npy (+ minmax png preview) per input image."""
    from pldepth_torch.serve.pipeline import (
        decode_image_chunk,
        depth_writer,
        run_pipeline,
        unique_stems,
    )
    from pldepth_torch.train.trainer import pad_to_batch

    trainer, state, mode = _serving_trainer(args)
    predict_fn = trainer.jit_predict(fused=mode)

    if os.path.isdir(args.inputs):
        files = sorted(
            f for ext in ("*.jpg", "*.jpeg", "*.png")
            for f in globmod.glob(os.path.join(args.inputs, ext))
        )
    else:
        files = [args.inputs]
    if not files:
        raise SystemExit(f"no images under {args.inputs}")
    os.makedirs(args.out_dir, exist_ok=True)

    bs = args.batch_size
    chunks = [files[s: s + bs] for s in range(0, len(files), bs)]
    calib = None
    if mode == "quant":
        # activation scales calibrate on the first input chunk, reused below
        calib = pad_to_batch(decode_image_chunk(chunks[0], args.input_size), bs)
        state = trainer.prepare_quant(state, calib)

    def decode(chunk):
        if calib is not None and chunk is chunks[0]:
            return calib
        return pad_to_batch(decode_image_chunk(chunk, args.input_size), bs)

    with contextlib.ExitStack() as window:
        if args.profile_dir:
            from pldepth_torch.obs.profiling import profile_trace

            window.enter_context(profile_trace(args.profile_dir))
        run_pipeline(
            chunks,
            decode,
            lambda imgs: predict_fn(state, imgs),
            depth_writer(args.out_dir, args.save_png, unique_stems(files)),
        )
    return {"n": len(files), "out_dir": args.out_dir}


N_CALIB_BATCHES = 8  # the daemon's scales calibrate over this many first batches


def serve(args: argparse.Namespace) -> dict:
    """Serving daemon (``pldepth_tpu/cli.py serve``) from a weights
    checkpoint: new images in ``--watch_dir`` become depth maps in
    ``--out_dir`` (serve/daemon.py)."""
    import numpy as np

    from pldepth_torch.serve.daemon import serve_directory
    from pldepth_torch.train.trainer import pad_to_batch

    if bool(args.load_model_path) == bool(args.artifact):
        raise SystemExit("pass exactly one of --load_model_path / --artifact")
    if args.artifact:
        from pldepth_torch.serve.daemon import artifact_infer

        infer, meta = artifact_infer(args.artifact, args.device)
        fixed = meta.get("batch_size")
        batch_size = fixed or args.batch_size
        # a fixed-batch artifact takes its batch only: tail chunks pad to it
        pad = (lambda a: pad_to_batch(a, fixed)) if fixed else None
        n = serve_directory(
            args.watch_dir, args.out_dir, infer, meta["input_size"], batch_size,
            pad_batch=pad, save_png=args.save_png, poll_interval=args.poll_interval,
            once=args.once,
        )
        return {"processed": n, "out_dir": args.out_dir}
    trainer, state, mode = _serving_trainer(args)
    predict_fn = trainer.jit_predict(fused=mode)
    if mode == "quant":
        # lazy calibration (the daemon may start on an empty directory),
        # over the first N_CALIB_BATCHES dispatched batches: one
        # unrepresentative first batch would otherwise pin the scales
        calib = {"batches": [], "state": None}

        def infer(imgs):
            if len(calib["batches"]) < N_CALIB_BATCHES:
                calib["batches"].append(np.asarray(imgs))
                calib["state"] = trainer.prepare_quant(state, calib["batches"])
                log.info("int8 activation scales calibrated on %d/%d dispatched batch(es)",
                         len(calib["batches"]), N_CALIB_BATCHES)
            return predict_fn(calib["state"], imgs)
    else:
        infer = lambda imgs: predict_fn(state, imgs)  # noqa: E731
    n = serve_directory(
        args.watch_dir, args.out_dir, infer, args.input_size, args.batch_size,
        pad_batch=lambda a: pad_to_batch(a, args.batch_size), save_png=args.save_png,
        poll_interval=args.poll_interval, once=args.once,
    )
    return {"processed": n, "out_dir": args.out_dir}


def export(args: argparse.Namespace) -> dict:
    """Write the inference forward of ``--load_model_path``'s weights to
    ``--out`` (``pldepth_tpu/cli.py export``; serve/export.py)."""
    from pldepth_torch.serve.export import export_predict

    trainer, state = _loaded_trainer(args)
    platforms = args.platforms
    export_predict(trainer, state, args.batch_size, args.out,
                   platforms=tuple(p.strip() for p in platforms.split(",")),
                   bn_fold=args.bn_fold)
    return {"out": args.out, "platforms": platforms, "batch_size": args.batch_size,
            "input_size": args.input_size}


def _join_group(args: argparse.Namespace):
    """The process's mesh: under a launcher (``WORLD_SIZE`` > 1) join the
    process group unless this process already has one; a group that cannot
    form raises, nothing falls back to one process."""
    from pldepth_torch.core import mesh as mesh_lib

    if int(os.environ.get("WORLD_SIZE", 1)) > 1 and not mesh_lib.current().active:
        return mesh_lib.init_distributed(device="cpu" if args.device == "cpu" else None)
    return mesh_lib.current()


def _make_config(kw: dict):
    """Config from flags (``pldepth_tpu/cli.py:_make_config``): a
    ``--config_json`` value applies where the flag still holds the
    ExperimentConfig default; flags win over the file."""
    from pldepth_torch.core.config import ExperimentConfig

    cfg_keys = {f.name for f in dataclasses.fields(ExperimentConfig)}
    values = {k: v for k, v in kw.items() if k in cfg_keys}
    if kw.get("mesh_model", 1) != 1:
        values["mesh"] = {"data": -1, "model": kw["mesh_model"]}
    if kw.get("config_json"):
        with open(kw["config_json"]) as f:
            file_vals = {k: v for k, v in json.load(f).items() if not k.startswith("_")}
        unknown = set(file_vals) - cfg_keys
        if unknown:
            raise SystemExit(f"unknown keys in {kw['config_json']}: {sorted(unknown)}")
        defaults = ExperimentConfig()
        for k, v in file_vals.items():
            if values.get(k, getattr(defaults, k)) == getattr(defaults, k):
                values[k] = v
    return ExperimentConfig.from_dict(values)


def _load_data(cfg):
    from pldepth_torch.data.datasets import get_dataset
    from pldepth_torch.data.pipeline import train_val_split

    if cfg.dataset.lower() in ("hr-wsi", "hr_wsi", "hrwsi"):
        ds = get_dataset("HR-WSI", root=cfg.data_root, split="train", size=cfg.ds_size,
                         shuffle=True, seed=cfg.seed, target_size=cfg.input_size)
    else:
        ds = get_dataset(cfg.dataset, size=cfg.ds_size, seed=cfg.seed,
                         target_size=cfg.input_size)
    return train_val_split(ds, cfg.val_split_denom)


def train(args: argparse.Namespace) -> dict:
    """Main training experiment (reference perform_pldepth_experiment):
    fit, then ``<run>/weights.npz``."""
    from pldepth_torch.data.pipeline import BatchIterator, pregenerate_val_rankings, val_batches
    from pldepth_torch.obs.logging import MetricLogger
    from pldepth_torch.train.checkpoint import (
        CheckpointManager,
        load_weights_npz,
        save_weights_npz,
    )
    from pldepth_torch.train.trainer import Trainer

    from pldepth_torch.core.mesh import make_mesh

    cfg = _make_config(vars(args))
    if args.resume and not args.run_name:
        raise SystemExit("--resume needs a fixed --run_name")
    mesh = _join_group(args)
    world, rank = mesh.world, mesh.rank
    # the (data, model) layout: feeds and stores are sharded by data index
    # (the model ranks of one index take the same samples)
    layout = make_mesh(cfg.mesh, mesh)
    if world > 1 and args.pack_cache and not cfg.data_resident:
        raise NotImplementedError(
            "--pack_cache has no shard contract across processes yet: "
            "ROADMAP.md queue 1 item 11, the packed feed under data parallelism")
    # every rank names rank 0's run directory
    run_name = mesh.broadcast_object(
        args.run_name or time.strftime("%d%m%y-%H%M%S") + f"_s{cfg.sampling_type}")
    train_ds, val_ds = _load_data(cfg)
    # a streaming data index steps through its stride of the set; the
    # resident batch_size is the global batch
    per_rank = len(train_ds) if cfg.data_resident else len(train_ds) // layout.data
    # the Trainer checks the training options before any file is written
    trainer = Trainer(cfg, max(1, per_rank // cfg.batch_size), device=args.device, mesh=layout)
    logger = MetricLogger(cfg.output_dir, run_name, cfg.to_dict(), cfg.use_wandb,
                          use_tensorboard=cfg.use_tensorboard, use_mlflow=cfg.use_mlflow,
                          mlflow_tracking_uri=cfg.mlflow_tracking_uri)
    state = trainer.init_state()
    if cfg.load_model_path:
        state = trainer.replicate(load_weights_npz(cfg.load_model_path, state))

    # full-state checkpoints by global step (one per epoch + one on SIGTERM)
    auto_ckpt = CheckpointManager(os.path.join(logger.dir, "autockpt"), keep=cfg.keep_checkpoints)
    if args.resume and auto_ckpt.latest_step() is not None:
        state = trainer.replicate(auto_ckpt.restore(state))
        print(f"resumed from step {state.step}", flush=True)
    # the feed, in the JAX command's precedence: resident store, pack, stream
    resident_store = train_iter = None
    if cfg.data_resident:
        from pldepth_torch.data.resident import build_resident_store

        # under spatial sharding each rank holds its image rows of the samples
        resident_store = build_resident_store(train_ds, trainer.device,
                                              shard_index=layout.data_index,
                                              num_shards=layout.data, rows=trainer.input_rows())
        shard = f" (rank {rank} of {world})" if world > 1 else ""
        print(f"resident store{shard}: {resident_store.n} samples, "
              f"{resident_store.nbytes / 1e9:.2f} GB in HBM, gt_scale "
              f"{resident_store.gt_scale!r}", flush=True)
    elif args.pack_cache:
        from pldepth_torch.data.packed import NativePackedIterator, pack_dataset

        if not os.path.exists(args.pack_cache):
            print(f"packing {len(train_ds)} samples -> {args.pack_cache}", flush=True)
            pack_dataset(train_ds, args.pack_cache)
        train_iter = NativePackedIterator(args.pack_cache, cfg.batch_size, seed=cfg.seed,
                                          start_step=state.step, ring=cfg.prefetch_depth)
    else:
        # each data index its stride of one permutation (the JAX command does
        # not shard this feed: ROADMAP.md, noted, not faults); under spatial
        # sharding the step cuts each batch to the rank's rows on the host
        train_iter = BatchIterator(train_ds, cfg.batch_size, seed=cfg.seed,
                                   start_step=state.step, prefetch=cfg.prefetch_depth,
                                   uint8_wire=cfg.uint8_wire, shard_index=layout.data_index,
                                   num_shards=layout.data)
    vfac = None
    if len(val_ds) // layout.data >= cfg.batch_size:
        # fixed val rankings from the thresholded sampler (hourglass_provider.py:22)
        val_rankings = pregenerate_val_rankings(
            val_ds, sampler_name="thresholded", rankings_per_image=cfg.val_rpi,
            ranking_size=cfg.ranking_size, threshold=cfg.equality_threshold, seed=cfg.seed,
            device=trainer.device)
        vfac = lambda: val_batches(val_ds, val_rankings, cfg.batch_size,  # noqa: E731
                                   shard_index=layout.data_index, num_shards=layout.data)
    ckpt = (CheckpointManager(os.path.join(logger.dir, "ckpt"), keep=cfg.keep_checkpoints)
            if cfg.model_checkpoints else None)

    class LogCB:
        def on_train_begin(self, tr):
            pass

        def on_step_end(self, tr, step, metrics):
            logger.log({f"step_{k}": v for k, v in metrics.items()}, step=step)

        def on_epoch_end(self, tr, st, epoch, history):
            logger.log({"loss": history["loss"][-1],
                        "val_loss": history["val_loss"][-1] if history["val_loss"] else None,
                        "lr": history["lr"][-1], "images_per_sec": history["ips"][-1]},
                       step=epoch)
            if ckpt is not None and history["val_loss"]:
                ckpt.maybe_save_best(epoch, st, history["val_loss"][-1])

        def on_train_end(self, tr, st, history):
            pass

    try:
        state, history = trainer.fit(
            state, train_iter, val_iter_factory=vfac, callbacks=[LogCB()], ckpt=auto_ckpt,
            resident_store=resident_store,
            profile_dir=os.path.join(logger.dir, "profile") if cfg.profile else None)
    finally:
        if train_iter is not None:
            train_iter.close()
    out = {"run_dir": logger.dir, "step": state.step, "loss": history["loss"],
           "val_loss": history["val_loss"]}
    if history.get("preempted"):
        print(f"preempted -- resume with: --run_name {run_name} --resume true", flush=True)
        logger.close()
        return {**out, "preempted": True}
    weights_path = os.path.join(logger.dir, "weights.npz")
    save_weights_npz(weights_path, state)
    print(f"weights saved to {weights_path}", flush=True)
    if rank == 0:  # the report forwards on one card; the other ranks wait
        _post_train_eval(cfg, trainer, state, val_ds, logger)
    mesh.barrier()
    logger.close()
    return {**out, "weights": weights_path}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def active(args: argparse.Namespace) -> dict:
    """Active learning (reference run_scripts/active_PLDepth.py:160-185):
    ``--load_model_path`` weights or ``--pretrain_epochs`` of ``fit``, then
    ``--rounds`` rounds of acquisition and fixed-ranking fit
    (active/loop.py), ``<run>/weights.npz``; returns the history."""
    from pldepth_torch.active import run_active_loop
    from pldepth_torch.data.pipeline import BatchIterator
    from pldepth_torch.obs.logging import MetricLogger
    from pldepth_torch.train.checkpoint import load_weights_npz, save_weights_npz
    from pldepth_torch.train.trainer import Trainer

    cfg = _make_config(vars(args))
    mesh = _join_group(args)
    train_ds, val_ds = _load_data(cfg)
    # the Trainer checks the training options before any file is written
    trainer = Trainer(cfg, max(1, len(train_ds) // cfg.batch_size), device=args.device)
    run_name = time.strftime("%d%m%y-%H%M%S") + "_active"
    logger = MetricLogger(cfg.output_dir, run_name, cfg.to_dict(), cfg.use_wandb,
                          use_tensorboard=cfg.use_tensorboard, use_mlflow=cfg.use_mlflow,
                          mlflow_tracking_uri=cfg.mlflow_tracking_uri)
    state = trainer.init_state()
    if cfg.load_model_path:
        state = load_weights_npz(cfg.load_model_path, state)
    elif args.pretrain_epochs:
        it = BatchIterator(train_ds, cfg.batch_size, seed=cfg.seed)
        try:
            state, _ = trainer.fit(state, it, epochs=args.pretrain_epochs)
        finally:
            it.close()
    store = None
    if cfg.data_resident and mesh.world > 1:
        # the resident acquisition path maps store rows to ds[i] of a store
        # that holds the whole pool (the JAX command's rule, cli.py:566-580)
        print("# --data_resident ignored for the active loop under multi-host "
              f"(process_count={mesh.world}); using the streaming acquisition path",
              file=sys.stderr, flush=True)
    elif cfg.data_resident:
        from pldepth_torch.data.resident import build_resident_store

        store = build_resident_store(train_ds, trainer.device)
    state, history = run_active_loop(
        trainer, state, train_ds, rounds=args.rounds, split=args.split_num,
        sigma=args.sigma, eval_ds=val_ds if len(val_ds) else None, seed=cfg.seed,
        logger=logger, store=store,
    )
    save_weights_npz(os.path.join(logger.dir, "weights.npz"), state)
    logger.close()
    return history


def dump(args: argparse.Namespace) -> str:
    """Offline (image, rankings) dump (reference active_learning/offline_data.py)."""
    from pldepth_torch.core.config import sampler_name_for_type
    from pldepth_torch.data.offline import dump_offline_data

    cfg = _make_config(vars(args))
    train_ds, _ = _load_data(cfg)
    return dump_offline_data(
        train_ds, args.out_dir,
        sampler_name=sampler_name_for_type(cfg.sampling_type),
        rankings_per_image=cfg.rankings_per_image,
        ranking_size=cfg.ranking_size,
        threshold=cfg.equality_threshold,
        seed=cfg.seed,
        image_format=args.image_format,
        device=args.device,
    )


def chi2(args: argparse.Namespace) -> dict:
    """Sampling chi^2 diagnostic (reference chi2compare.py:27-165)."""
    from pldepth_torch.diagnostics.chi2 import run_chi2_compare

    return run_chi2_compare(_make_config(vars(args)), trials=args.trials,
                            batches_per_trial=args.batches_per_trial, device=args.device)


def analyze(args: argparse.Namespace) -> dict:
    """Sweep analysis: best trial and param-vs-metric plots (reference
    bk-hyperopt/trials_visualize.py HyperoptAnalyser)."""
    from pldepth_torch.sweep.analyze import best_trial, load_trials, plot_param_vs_metric

    trials = load_trials(args.state_path)
    best = best_trial(trials, args.target)
    plots = plot_param_vs_metric(args.state_path, args.out_dir, args.target)
    return {"best": best, "plots": plots}


def convert(args: argparse.Namespace) -> dict:
    """Keras weights -> the npz of ``--pretrained_path`` (reference encoders
    came from keras.applications, pl_hourglass.py:48 / redweb.py:410), or
    with ``--reverse`` a weights npz -> a Keras .h5 the reference stack
    loads (test_data_eval.py:70-85). Needs TensorFlow; runs on the host."""
    from pldepth_torch.models import convert as cv

    if args.reverse:
        path, n = cv.export_npz_to_keras_file(args.weights, args.model_name, args.out,
                                              template_h5=args.template or None,
                                              input_size=args.input_size)
        return {"out": path, "model_name": args.model_name, "tensors_assigned": n}
    path = cv.convert_keras_file(args.weights, args.model_name, args.out)
    return {"out": path, "model_name": args.model_name}


def warmup(args: argparse.Namespace) -> dict:
    """Build what a config runs and run each of its graphs once (the
    counterpart of ``pldepth_tpu/cli.py warmup``, which fills the XLA
    compile cache). The port compiles no graph: what a first run pays for
    is the kernel libraries (``ops/_build.py``, one nvcc each, in parallel,
    into ``BUILD_DIR``; only on the card) and the packed reader
    (``data/packed.py:build_native``), then the first call of each path
    (cuDNN and cuBLAS set-up, the libraries' loading): one train step on
    zeros on a throwaway state, with ``--data_resident true`` one resident
    step (or chain) on a small seeded store, with ``--serve_batch B``
    ``predict`` and ``predict_bnfold`` at batch B. Only the build carries
    over to a later process; the first-call costs are the process's own.
    Returns the seconds of each, the libraries built by this call and
    ``cache_dir`` (the build directory)."""
    import numpy as np

    from pldepth_torch.core.device import resolve_device
    from pldepth_torch.data import packed
    from pldepth_torch.ops import _build
    from pldepth_torch.train.trainer import Trainer

    mesh = _join_group(args)
    device = resolve_device(args.device)
    cfg = _make_config(vars(args))
    t0 = time.perf_counter()
    built = sorted(_build.build()) if device.type == "cuda" else []
    if not packed.library_path().exists():
        packed.build_native()
        built.append("packio")
    out = {"cache_dir": str(_build.BUILD_DIR), "built": built,
           "build_s": time.perf_counter() - t0}
    if mesh.active:  # the group's communicators, set up before any long step
        from pldepth_torch.core.mesh import warmup_collectives

        out["collectives"] = warmup_collectives(mesh)

    def timed(key, fn):
        _sync(device)
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        out[key] = time.perf_counter() - t0
        return res

    trainer = Trainer(cfg, steps_per_epoch=1, device=device)
    state = trainer.init_state()
    shape = (cfg.batch_size, cfg.input_size, cfg.input_size)
    batch = {"image": np.zeros((*shape, 3), np.float32), "gt": np.ones(shape, np.float32),
             "mask": np.ones(shape, np.float32)}
    state = timed("train_step_s", lambda: trainer.train_step(state, batch)[0])
    if cfg.data_resident:
        from pldepth_torch.data import SyntheticDepthDataset
        from pldepth_torch.data.resident import build_resident_store

        store = build_resident_store(SyntheticDepthDataset(
            n=max(cfg.batch_size, 2), image_size=cfg.input_size, seed=0), device)
        step = (trainer.resident_chain(cfg.resident_chain_steps)
                if cfg.resident_chain_steps > 1 else trainer.resident_step)
        state = timed("resident_s", lambda: step(state, store.arrays)[0])
    if args.serve_batch:
        imgs = np.zeros((args.serve_batch, cfg.input_size, cfg.input_size, 3), np.float32)
        for key, mode in (("predict_s", False), ("predict_bnfold_s", "bn_fold")):
            fn = trainer.jit_predict(fused=mode)
            timed(key, lambda: np.asarray(fn(state, imgs)))
    return out


def sweep(args: argparse.Namespace) -> dict:
    """Hyperparameter sweep (reference pldepth/hyperopt/sweep.py adapters):
    ``--search wandb`` drives the runs from a wandb sweep server (bayes);
    random / grid / tpe run locally with ``sweep_state.jsonl`` resume."""
    from pldepth_torch.sweep import sweep as sw

    cfg = _make_config(vars(args))
    if args.search == "wandb":
        return sw.run_wandb_sweep(cfg, num_runs=args.num_runs, target=args.target,
                                  space_name=args.space_name, sweep_id=args.sweep_id,
                                  device=args.device)
    return sw.run_sweep(cfg, num_runs=args.num_runs, search=args.search, target=args.target,
                        space_name=args.space_name, device=args.device)


def _post_train_eval(cfg, trainer, state, val_ds, logger) -> None:
    """Ordinal error and NDCG@200 on up to 250 val images, an example image
    (reference PLDepth.py:184-209), and with ``--parity_report`` the full
    report and the verdict of docs/PARITY.md in ``parity_report.json``."""
    import numpy as np

    from pldepth_torch.eval.evaluator import Evaluator

    evaluator = Evaluator(trainer, state)
    limit = min(250, len(val_ds)) if len(val_ds) else None
    if limit:
        err = evaluator.calc_err(val_ds, limit=limit)
        ndcg = evaluator.dcg_metric(val_ds, limit=limit)
        logger.set_summary(test_error=err, ndcg_200=ndcg)
        print(json.dumps({"test_error": err, "ndcg_200": ndcg}), flush=True)
        ex = val_ds[min(10, len(val_ds) - 1)]
        pred = np.asarray(trainer.jit_predict()(state, np.asarray(ex["image"])[None]))[0]
        logger.log_images({"ex_img": ex["image"], "ex_gt": ex["gt"], "ex_pred": pred},
                          captions={"ex_img": "input image", "ex_gt": "input ground truth",
                                    "ex_pred": "predicted depth"})
    if not (cfg.parity_report and len(val_ds)):
        return
    report = evaluator.full_report(val_ds, limit=limit)
    report["config"] = {
        "model_name": cfg.model_name, "input_size": cfg.input_size,
        "ranking_size": cfg.ranking_size, "dataset": cfg.dataset,
        "ds_size": cfg.ds_size, "epochs": cfg.epochs,
        "sampling_type": cfg.sampling_type,
    }
    if cfg.parity_target_whdr >= 0:
        report["parity"] = {
            "target_whdr": cfg.parity_target_whdr,
            "budget": cfg.parity_budget,
            "pass": bool(report["whdr_tau_0.03"] <= cfg.parity_target_whdr + cfg.parity_budget),
        }
    path = os.path.join(logger.dir, "parity_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({"parity_report": path,
                      **{k: v for k, v in report.items() if not isinstance(v, dict)}}),
          flush=True)
    if "parity" in report:
        print(f"PARITY {'PASS' if report['parity']['pass'] else 'FAIL'}: "
              f"WHDR {report['whdr_tau_0.03']:.4f} vs target "
              f"{cfg.parity_target_whdr:.4f} + {cfg.parity_budget:.3f}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    logging.basicConfig(level=os.environ.get("PLDEPTH_LOG", "INFO"),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    if args.command == "eval":
        print(json.dumps(eval_cmd(args), indent=2))
    elif args.command == "zeroshot":
        print(json.dumps(zeroshot(args), indent=2))
    elif args.command == "predict":
        print(json.dumps(predict(args)))
    elif args.command == "serve":
        print(json.dumps(serve(args)))
    elif args.command == "train":
        print(json.dumps(train(args)))
    elif args.command == "export":
        print(json.dumps(export(args)))
    elif args.command == "active":
        print(json.dumps(active(args)))
    elif args.command == "dump":
        print(dump(args))
    elif args.command == "chi2":
        print(json.dumps(chi2(args), indent=2))
    elif args.command == "analyze":
        print(json.dumps(analyze(args), indent=2))
    elif args.command == "convert":
        print(json.dumps(convert(args)))
    elif args.command == "warmup":
        print(json.dumps(warmup(args)))
    elif args.command == "sweep":
        print(json.dumps(sweep(args), indent=2))
    return 0


def launched_main(argv: Optional[List[str]] = None) -> int:
    """``main``, leaving the process group it may have joined on the way
    out (the module's entry point; a caller that made the group keeps
    it)."""
    from pldepth_torch.core import mesh as mesh_lib

    had_group = mesh_lib.current().active
    try:
        return main(argv)
    finally:
        if not had_group:
            mesh_lib.shutdown()


if __name__ == "__main__":
    sys.exit(launched_main())
