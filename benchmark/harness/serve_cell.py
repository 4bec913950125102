"""A serving cell: ``serve/pipeline.py:run_pipeline`` over the serving
callable of ``cli predict``'s default mode, as a closed loop.

``decode`` is a lookup into the cell's cached host f32 chunks, ``infer``
the program's ``Trainer.jit_predict(mode)``, ``write`` an in-memory sink
that stamps each chunk's completion and keeps a sample of the served
maps, drawn from the seed by reservoir sampling. The window closes at the
first chunk handed to ``decode`` after ``--seconds``; the chunks already
in flight complete and count. After the window the program's state is
freed and the reference (reference/nets.py, quantized) serves the sampled
chunks from the same weights, working out its own BN fold, weight
quantization and calibration on the same calibration chunk."""

from __future__ import annotations

import gc
import threading
import time
from typing import Optional

import numpy as np
import torch

from benchmark.harness import check, costs, inputs, program, trace
from benchmark.reference import nets


class WindowClosed(Exception):
    pass


class Sink:
    """The write stage: completion stamps and a seeded reservoir of maps."""

    def __init__(self, seed: int, keep: int):
        self.rng = np.random.default_rng((seed, 7))
        self.keep = keep
        self.done = {}
        self.sample = {}
        self.count = 0
        self.lock = threading.Lock()

    def __call__(self, item, host) -> None:
        now = time.perf_counter()
        with self.lock:
            self.done[item] = now
            j = self.count
            self.count += 1
            if j < self.keep:
                self.sample[j] = (item, np.array(host))
            else:
                r = int(self.rng.integers(0, j + 1))
                if r < self.keep:
                    self.sample[r] = (item, np.array(host))


def chunks_of(seed: int, n: int, batch: int):
    """The cell's chunks: a seeded permutation of the ``n`` images cut into
    whole batches; ``decode`` hands them out in turn."""
    order = np.random.default_rng(seed).permutation(n)
    return [order[i:i + batch] for i in range(0, n - batch + 1, batch)]


def run(cell: dict, seed: int, seconds: float, traced: bool, t_start: float, parts: dict,
        tmpdir: str = "/tmp", fault: Optional[str] = None, device: str = "cuda") -> dict:
    cfgd, traffic = cell["config"], cell["traffic"]
    t = time.time()
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.serve.pipeline import run_pipeline
    from pldepth_torch.train.trainer import Trainer

    parts["import"] = time.time() - t
    dev = torch.device(device)
    mode = traffic["mode"]
    if dev.type == "cuda":
        t = time.time()
        from pldepth_torch.ops import _build

        _build.build(("quant_matmul",))
        _build.load_library("quant_matmul")
        parts["build_cache"] = time.time() - t

    model, size = cfgd["model_name"], cfgd["input_size"]
    batch, n_images = traffic["batch_size"], traffic["images"]
    keys = set(ExperimentConfig.__dataclass_fields__)
    cfg = ExperimentConfig.from_dict({k: v for k, v in cfgd.items() if k in keys})

    t = time.time()
    data = inputs.depth_set(seed, n_images, size, dev)
    chunk_rows = chunks_of(seed, n_images, batch)
    host = data["image"].cpu().numpy()
    chunks = [np.ascontiguousarray(host[r]) for r in chunk_rows]
    parts["data"] = time.time() - t

    t = time.time()
    w = inputs.weights(seed, model, dev,
                       batch_stats_images=data["image"][torch.as_tensor(chunk_rows[-1][:8])])
    del data
    trainer = Trainer(cfg, device=dev)
    state = program.state_with(trainer, w, dev)
    parts["weights"] = time.time() - t

    t = time.time()
    if mode != "quant":
        raise ValueError(f"serving mode {mode!r} has no reference here")
    served = trainer.prepare_quant(state, chunks[0])
    predict_fn = trainer.jit_predict(fused=mode)
    parts["calibration"] = time.time() - t

    issue = []
    tracer = trace.Window(tmpdir) if traced else None
    if tracer is not None:
        tracer.prime()
    traced_chunks = [0]
    win = {"trace_from": None, "trace_to": None, "trace_seconds": 0.0}

    def infer(x):
        now = time.perf_counter()
        if tracer is not None and win["trace_from"] is not None:
            if tracer.prof is None and now >= win["trace_from"]:
                tracer.start()  # the profiler's own start-up is not in the window
                win["trace_to"] = tracer.t0 + win["trace_seconds"]
            elif tracer.active and now >= win["trace_to"]:
                tracer.stop()
        t = time.perf_counter()
        out = predict_fn(served, x)
        issue.append(time.perf_counter() - t)
        if tracer is not None and tracer.active:
            traced_chunks[0] += 1
        if fault == "altered":  # an answer altered where it is produced
            out = np.asarray(out)[:, ::-1].copy()
        return out

    t = time.time()
    warm = Sink(seed, 0)
    run_pipeline(list(range(traffic["warm_chunks"])), lambda i: chunks[i % len(chunks)],
                 infer, warm)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    parts["warm"] = time.time() - t
    issue.clear()

    # ---- the window
    sink = Sink(seed, traffic["check_chunks"])
    handed = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    deadline = t0 + seconds
    if traced:
        win["trace_from"] = t0 + min(traffic["trace_start_s"], 0.3 * seconds)
        win["trace_seconds"] = min(traffic["trace_seconds"], 0.3 * seconds)

    def decode(i):
        now = time.perf_counter()
        if now >= deadline:
            raise WindowClosed
        handed[i] = now
        return chunks[i % len(chunks)]

    try:
        run_pipeline(range(traffic["max_chunks"]), decode, infer, sink)
    except WindowClosed:
        pass
    if tracer is not None and tracer.active:
        tracer.stop()
    done = sorted(sink.done)
    t_end = max(sink.done.values())
    lat = [sink.done[i] - handed[i] for i in done]
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    out = {"kind": "serve", "setup_s": setup_s, "window_s": t_end - t0, "chunks": len(done),
           "images": len(done) * batch, "peak_bytes": peak,
           "attempted": len(handed) * batch, "failed": (len(handed) - len(done)) * batch,
           "latency_s": lat, "spans": {"serve.infer": list(issue)}, "trace": None}
    if tracer is not None and tracer.prof is not None:
        out["trace"] = tracer.read()
        out["trace"]["chunks"] = traced_chunks[0]

    # ---- the check: the program freed, then the reference
    sample = [sink.sample[j] for j in sorted(sink.sample)]
    del trainer, state, served, predict_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.time()
    worst = 0.0
    ref = QuantReference(model, w, torch.from_numpy(chunks[0]).to(dev), traffic["bits"])
    for item, got in sample:
        want = ref(torch.from_numpy(chunks[item % len(chunks)]).to(dev))
        worst = max(worst, check.serve_number(torch.from_numpy(got).to(dev), want))
    out["check_s"] = time.time() - t
    out["numbers"] = {"map_gap": worst}
    out["checked_images"] = len(sample) * batch
    out["costs"] = {"least_s_per_image": costs.serve_least_s(model, 1, size),
                    "k4_least_s_per_forward": costs.k4_least_s(model, batch, size),
                    "k4_sites": len(costs.k4_sites(model, 1, size))}
    return out


class QuantReference:
    """The reference's quantized serving graph: BN folded, weights and
    activations quantized to ``bits``, activation scales calibrated on
    ``calib`` (the maxima the folded, weight-quantized float graph sees)."""

    def __init__(self, model: str, params, calib: torch.Tensor, bits: int = 8):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model, self.params, self.bits = model, params, bits
        self.pairs = nets.spec(model, 1, 32, device="cpu").pairs
        self.folded = nets.fold(params, self.pairs)
        ctx = self._ctx("calib")
        with torch.no_grad():
            nets.forward(ctx, model, calib)
        self.scales = ctx.amax

    def _ctx(self, quant: str) -> nets.Ctx:
        ctx = nets.Ctx(self.params, quant=quant, bits=self.bits,
                       scales=getattr(self, "scales", None))
        ctx.folded = self.folded
        return ctx

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return nets.forward(self._ctx("int"), self.model, images)


def variant_numbers(cell: dict, seed: int, dev, bits: int) -> dict:
    """The reference served at ``bits`` in the program's place, against the
    reference at the configuration's bits, on the chunks a run would
    sample from (the control's readings)."""
    cfgd, traffic = cell["config"], cell["traffic"]
    model, size, batch = cfgd["model_name"], cfgd["input_size"], traffic["batch_size"]
    data = inputs.depth_set(seed, traffic["images"], size, dev)
    rows = chunks_of(seed, traffic["images"], batch)
    images = data["image"]
    w = inputs.weights(seed, model, dev,
                       batch_stats_images=images[torch.as_tensor(rows[-1][:8])])
    calib = images[torch.as_tensor(rows[0])]
    ref = QuantReference(model, w, calib, traffic["bits"])
    low = QuantReference(model, w, calib, bits)
    rng = np.random.default_rng((seed, 7))
    worst = 0.0
    for c in rng.choice(len(rows), size=traffic["check_chunks"], replace=False):
        x = images[torch.as_tensor(rows[c])]
        worst = max(worst, check.serve_number(low(x), ref(x)))
    return {"map_gap": worst}
