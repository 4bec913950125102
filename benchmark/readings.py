"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 benchmark/readings.py --workload <name> --seeds 12 --controls 3 \\
        [--seconds 3] [--first-seed N] [--out readings.json]

In one process: the program's numbers on ``--seeds`` seeds (a short
window each; a training cell's numbers come from set-up), then on
``--controls`` seeds the control (the reference in the program's place at
the precision below the configuration's: float8 e4m3 convolutions for a
bfloat16 training cell, int4 for an int8 serving cell) and, for a
training cell, the planted faults in the reference put in the program's
place: half the batch, and every update with the wrong sign. Prints one JSON line a
reading and writes them all to ``--out``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2_000_000_011)
    p.add_argument("--out", default=None)
    p.add_argument("--dtype", default=None,
                   help="run the program at this compute dtype instead (a look at a cause)")
    p.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    p.add_argument("--no-tf32", action="store_true",
                   help="float32 convolutions and products without TF32 in the program too")
    args = p.parse_args()
    from benchmark.harness import guard, manifest

    for k, v in guard.ENV.items():
        os.environ.setdefault(k, v)
    import torch

    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cell = manifest.cell(args.workload)
    chips = cell["workload"]["chips"]
    if chips > 1 and args.rank < 0:
        return spawn(chips)
    rank = max(args.rank, 0)
    cell["init_method"] = args.init_method
    if args.dtype:
        cell["config"]["compute_dtype"] = args.dtype
    kind = cell["traffic"]["kind"]
    dev = torch.device("cuda")
    rows = []

    def note(row):
        if rank == 0:
            rows.append(row)
            print(json.dumps(row), flush=True)

    seeds = [args.first_seed + 7919 * i for i in range(max(args.seeds, args.controls))]
    for seed in seeds[:args.seeds]:
        t = time.time()
        if kind == "train":
            from benchmark.harness import train_cell as mod
        else:
            from benchmark.harness import serve_cell as mod
        kw = {"world": chips, "rank": rank} if kind == "train" else {}
        out = mod.run(cell, seed, args.seconds, False, t, {}, tmpdir=tempfile.gettempdir(), **kw)
        what = "program" + (f"_{args.dtype}" if args.dtype else "") + (
            "_no_tf32" if args.no_tf32 else "")
        note({"what": what, "seed": seed,
              "numbers": out["numbers"], "detail": out.get("detail"),
              "losses": out.get("losses"), "ref_losses": out.get("ref_losses"),
              "s": time.time() - t})
    for seed in seeds[:args.controls]:
        t = time.time()
        if kind == "train":
            from benchmark.harness import train_cell

            note({"what": "control_fp8", "seed": seed,
                  "numbers": train_cell.variant_numbers(cell, seed, dev, lowp="fp8",
                                                        world=chips, rank=rank),
                  "s": time.time() - t})
            for fault in ("half_batch", "sign_flip"):
                t = time.time()
                note({"what": f"fault_{fault}", "seed": seed,
                      "numbers": train_cell.variant_numbers(cell, seed, dev, fault=fault,
                                                            world=chips, rank=rank),
                      "s": time.time() - t})
        else:
            from benchmark.harness import serve_cell

            note({"what": "control_int4", "seed": seed,
                  "numbers": serve_cell.variant_numbers(cell, seed, dev, bits=4),
                  "s": time.time() - t})
    if args.out and rank == 0:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def spawn(chips: int) -> int:
    """This command once a rank, each on its own cores and card (as
    benchmark/run.py starts a multi-card cell)."""
    from benchmark.harness import affinity
    from benchmark.run import _free_port

    cores = affinity.split(affinity.allowed(), chips)
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = []
    for r in range(chips):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(chips), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(chips), **affinity.thread_env(cores[r]))
        procs.append(subprocess.Popen(
            [sys.executable, *sys.argv, "--rank", str(r), "--init-method", init], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL,
            preexec_fn=lambda c=cores[r]: os.sched_setaffinity(0, c)))
    codes = [p.wait() for p in procs]
    return max(codes, key=abs)


if __name__ == "__main__":
    sys.exit(main())
