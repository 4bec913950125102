"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (one profiler window inside
the measured window). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each compared
number beside its limit (also the last lines of standard error).

A four-card cell starts its four rank processes here, before torch is
imported, each pinned to a disjoint set of the cores this process may
use; rank 0 prints the line. Without CUDA, or with fewer cards than the
cell asks for, a run (or each rank) exits 3 and prints no result. Build and kernel caches stay in fixed directories inside
the checkout.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = ROOT / ".bench_cache"


def _env() -> None:
    from benchmark.harness import guard

    for k, v in guard.ENV.items():
        os.environ.setdefault(k, v)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-card cell (set by the parent run)
    p.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    p.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(args, chips: int) -> int:
    """Start the cell's ranks on disjoint cores, wait for all of them; a rank
    that fails ends the others."""
    from benchmark.harness import affinity

    cores = affinity.split(affinity.allowed(), chips)
    init = f"tcp://127.0.0.1:{_free_port()}"
    print(json.dumps({"ranks": chips, "cores": cores, "init_method": init}), file=sys.stderr,
          flush=True)
    procs = []
    for r in range(chips):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(chips), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(chips), **affinity.thread_env(cores[r]))
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
               str(args.trace), "--rank", str(r), "--t-start", repr(T_START),
               "--init-method", init]
        procs.append(subprocess.Popen(
            cmd, env=env, stdout=None if r == 0 else sys.stderr,
            preexec_fn=lambda c=cores[r]: os.sched_setaffinity(0, c)))
    rc = 0
    try:
        live = list(procs)
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0:
                    rc = rc or code
                    for q in live:
                        q.terminate()
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return rc


def main(argv=None) -> int:
    args = _args(argv)
    _env()
    from benchmark.harness import guard, manifest

    cell = manifest.cell(args.workload)
    chips = cell["workload"]["chips"]
    if chips > 1 and args.rank < 0:
        # the ranks start before this process would import torch: each
        # looks for the cards itself
        return spawn_ranks(args, chips)
    import torch

    from benchmark.harness import result

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: workload {args.workload} needs {chips} CUDA card(s), have {have}",
              file=sys.stderr)
        return 3
    t_start = args.t_start if args.t_start is not None else T_START
    tmpdir = tempfile.gettempdir()
    # set-up by part: from process start to here, Python, torch and the
    # card's context; the cell's own parts follow
    parts = {"start": time.time() - t_start}
    kind = cell["traffic"]["kind"]
    if kind == "train":
        from benchmark.harness import train_cell

        cell["init_method"] = args.init_method
        out = train_cell.run(cell, args.seed, args.seconds, bool(args.trace), t_start, parts,
                             world=chips, rank=max(args.rank, 0), tmpdir=tmpdir)
    elif kind == "serve":
        from benchmark.harness import serve_cell

        out = serve_cell.run(cell, args.seed, args.seconds, bool(args.trace), t_start, parts,
                             tmpdir=tmpdir)
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    try:
        line = result.assemble(cell, out, parts, bool(args.trace), chips, max(args.rank, 0))
    except manifest.MissingMetric as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 5
    if chips > 1:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    if line is None:  # a rank other than 0
        return 0
    bad = guard.loaded()
    if bad:
        print(f"benchmark: modules loaded in the result's process: {bad}", file=sys.stderr)
        return 4
    result.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
