"""Command line of the port: ``python -m pldepth_torch.cli predict ...``.

The ``predict`` command of ``pldepth_tpu/cli.py`` with the same flag names,
defaults and ``true``/``false`` booleans, written with argparse, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels). The other commands come with later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import os
import sys
from typing import List, Optional

_TRUE = {"1", "true", "t", "yes", "y", "on"}
_FALSE = {"0", "false", "f", "no", "n", "off"}


def _bool(s: str) -> bool:
    v = s.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise argparse.ArgumentTypeError(f"{s!r} is not a valid boolean")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pldepth_torch")
    sub = p.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("predict", help="batched depth-map inference (serving path)")
    pr.add_argument("--model_name", default="ff_effnet")
    pr.add_argument("--load_model_path", required=True)
    pr.add_argument("--inputs", required=True,
                    help="image file or directory of images")
    pr.add_argument("--out_dir", required=True)
    pr.add_argument("--input_size", default=448, type=int)
    pr.add_argument("--batch_size", default=8, type=int)
    pr.add_argument("--save_png", default=True, type=_bool)
    pr.add_argument("--fused_encoder", default=False, type=_bool,
                    help="run every encoder MBConv block on the fused kernel "
                         "(ff_effnet family)")
    pr.add_argument("--bn_fold", default=True, type=_bool,
                    help="BN-folded serving graph (not ported yet); "
                         "--fused_encoder takes precedence")
    pr.add_argument("--quantize", default="auto", choices=["auto", "", "int8"],
                    help="int8 serving (not ported yet); 'auto' = int8 for the "
                         "ff_effnet family unless --fused_encoder/--bn_fold "
                         "override")
    pr.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return p


def predict(args: argparse.Namespace) -> dict:
    """Writes <name>_depth.npy (+ minmax png preview) per input image."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.serve.pipeline import (
        decode_image_chunk,
        depth_writer,
        run_pipeline,
        unique_stems,
    )
    from pldepth_torch.train.checkpoint import infer_decoder_head_ch, load_weights_npz
    from pldepth_torch.train.trainer import Trainer, pad_to_batch

    cfg = ExperimentConfig(
        model_name=args.model_name, input_size=args.input_size,
        decoder_head_ch=infer_decoder_head_ch(args.load_model_path),
    )
    mode = Trainer.serving_mode(args.fused_encoder, args.bn_fold, args.quantize,
                                model_name=args.model_name)
    trainer = Trainer(cfg, steps_per_epoch=1, device=args.device)
    predict_fn = trainer.jit_predict(fused=mode)
    state = load_weights_npz(args.load_model_path, trainer.init_state())

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
    run_pipeline(
        chunks,
        lambda chunk: pad_to_batch(decode_image_chunk(chunk, args.input_size), bs),
        lambda imgs: predict_fn(state, imgs),
        depth_writer(args.out_dir, args.save_png, unique_stems(files)),
    )
    return {"n": len(files), "out_dir": args.out_dir}


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "predict":
        print(json.dumps(predict(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
