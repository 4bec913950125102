"""The program's spans (pldepth_torch/obs/spans.py) on the CPU: the
recorder's nesting, parents, threads and shared identifiers; off by
default, recording nothing; the phases of a train step under one ``step``,
``fit``'s spans, ``run_pipeline``'s spans for each chunk; and the clock: a
span laid over a ``torch.profiler`` Chrome trace through the trace's
``baseTimeNanoseconds`` holds the op it wrapped. (The mesh's spans under
a two-process gloo group: tests/test_torch_dp.py; a span over a kernel on
the card: tests/test_torch_cuda.py.)"""

import json
import threading

import numpy as np
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.obs import spans
from pldepth_torch.train import Trainer

torch.set_num_threads(1)
S = 32
PHASES = ["step", "step.upload", "step.sample", "step.forward", "step.backward", "step.update"]


def _batch(seed=0, n=2):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(size=(n, S, S, 3)).astype(np.float32),
            "gt": rng.uniform(0.1, 1, (n, S, S)).astype(np.float32),
            "mask": np.ones((n, S, S), np.float32)}


@pytest.fixture(scope="module")
def trainer():
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=S, batch_size=2,
                                  ranking_size=3, rankings_per_image=8), steps_per_epoch=2,
                 device="cpu")
    state, _ = tr.train_step(tr.init_state(), _batch())  # first-use costs
    return tr, state


def test_spans_nest_with_parents_threads_and_idents():
    seen = {}

    def other():
        with spans.span("other"):  # no span open on this thread: no parent
            seen["thread"] = threading.get_native_id()

    with spans.recording() as rec:
        with spans.span("outer", 7):
            with spans.span("inner"):
                with spans.span("own", 9):
                    pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        at = spans.stamp()
        spans.add("wait", at, at + 5, 3)
    got = {s.name: s for s in rec.spans}
    assert list(got) == ["outer", "inner", "own", "other", "wait"]
    assert got["outer"].parent is None and got["outer"].ident == 7
    assert got["inner"].parent == got["outer"].id and got["inner"].ident == 7
    assert got["own"].parent == got["inner"].id and got["own"].ident == 9
    assert got["other"].parent is None and got["other"].ident is None
    me = threading.get_native_id()
    assert got["outer"].thread == got["inner"].thread == me
    assert got["other"].thread == seen["thread"] != me
    assert got["wait"].thread is None and got["wait"].parent is None
    assert (got["wait"].ident, got["wait"].end_ns - got["wait"].start_ns) == (3, 5)
    for child, parent in (("inner", "outer"), ("own", "inner"), ("other", "outer")):
        assert got[parent].start_ns <= got[child].start_ns <= got[child].end_ns \
            <= got[parent].end_ns
    assert len({s.id for s in rec.spans}) == len(rec.spans)


def test_recording_is_off_by_default_and_records_nothing_while_off():
    off = spans.span("a", 1)
    assert off is spans.span("b") is spans._NOOP  # shared, nothing built
    with off:
        pass
    assert spans.stamp() is None
    spans.add("a", 5, 9)  # dropped
    with spans.span("before"):
        with spans.recording() as rec:
            with pytest.raises(RuntimeError, match="already on"):
                with spans.recording():
                    pass
            with spans.span("during"):
                pass
    with spans.span("after"):
        pass
    assert [s.name for s in rec.spans] == ["during"]
    assert rec.spans[0].parent is None  # "before" opened while off
    assert spans.span("c") is spans._NOOP


@pytest.mark.parametrize("entry", ["train_step", "train_step_fixed", "resident_step"])
def test_a_train_step_yields_its_phases_in_order_under_one_step(trainer, entry):
    tr, state = trainer
    b = _batch(1)
    with spans.recording() as rec:
        if entry == "train_step":
            new, _ = tr.train_step(state, b)
        elif entry == "train_step_fixed":
            rankings = np.stack([np.arange(24).reshape(8, 3)] * 2).astype(np.int32)
            new, _ = tr.train_step_fixed(state, {"image": b["image"], "rankings": rankings})
        else:
            arrays = {"image": torch.from_numpy((b["image"] * 255).astype(np.uint8)),
                      "gt": torch.from_numpy((b["gt"] * 1000).astype(np.int16)),
                      "gt_scale": torch.tensor(1e-3), "mask": torch.from_numpy(
                          b["mask"].astype(np.uint8))}
            new, _ = tr.resident_step(state, arrays)
    assert new.step == state.step + 1
    want = PHASES if entry != "train_step_fixed" else [p for p in PHASES if p != "step.sample"]
    got = rec.spans
    if entry == "resident_step":  # the draw comes before the step, outside it
        assert got[0].name == "step.draw" and got[0].parent is None
        assert got[0].end_ns <= got[1].start_ns
        got = got[1:]
    assert [s.name for s in got] == want
    step = got[0]
    assert step.parent is None
    assert {s.ident for s in rec.spans} == {state.step}
    assert all(s.parent == step.id and s.thread == step.thread for s in got[1:])
    for a, b_ in zip(got[1:], got[2:]):  # one after another, inside the step
        assert a.end_ns <= b_.start_ns
    assert step.start_ns <= got[1].start_ns and got[-1].end_ns <= step.end_ns


def test_fit_records_the_feed_and_the_epochs_readback(trainer):
    tr, state = trainer

    def feed():
        i = 0
        while True:
            i += 1
            yield _batch(i)

    with spans.recording() as rec:
        state2, _ = tr.fit(state, feed(), epochs=state.step // tr.steps_per_epoch + 1)
    names = [s.name for s in rec.spans if s.parent is None]
    steps = state2.step - state.step
    assert steps >= 1 and names.count("step") == steps
    assert names.count("fit.feed") == steps + 1  # the first batch, then one a step
    assert names[0] == "fit.feed" and names[-1] == "fit.epoch"
    # the batch of step s is fetched under ident s (on the CPU no step has
    # an event to wait on, so no fit.wait)
    feeds = [s.ident for s in rec.spans if s.name == "fit.feed"]
    assert feeds == list(range(state.step, state2.step + 1))
    assert "fit.wait" not in names


def test_run_pipeline_records_each_chunks_spans(trainer):
    from pldepth_torch.serve.pipeline import run_pipeline

    tr, state = trainer
    predict = tr.jit_predict()
    chunks = [_batch(i)["image"] for i in range(5)]
    done = {}
    with spans.recording() as rec:
        n = run_pipeline(range(5), chunks.__getitem__, lambda x: predict(state, x),
                         lambda i, host: done.__setitem__(i, host.shape), prefetch=2,
                         writers=1)
    assert n == 5 and sorted(done) == list(range(5))
    for i in range(5):
        mine = {s.name: s for s in rec.spans if s.ident == i}
        assert set(mine) == {"serve.queue", "serve.infer", "upload", "serve.wait",
                             "serve.write_wait"}, (i, sorted(mine))
        assert mine["upload"].parent == mine["serve.infer"].id
        assert mine["serve.queue"].thread is None
        assert mine["serve.queue"].end_ns <= mine["serve.infer"].start_ns
        assert mine["serve.infer"].end_ns <= mine["serve.wait"].start_ns \
            <= mine["serve.wait"].end_ns <= mine["serve.write_wait"].start_ns


def test_a_span_lands_on_its_op_in_a_profiler_trace(tmp_path):
    """The recorder's clock is the Chrome trace's: ``ts`` (us) plus
    ``baseTimeNanoseconds`` / 1000, and its thread the trace's ``tid``."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x + 1
        with spans.recording() as rec:
            with spans.span("mm"):
                torch.mm(x, x)
        x + 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    (s,) = rec.spans
    mm = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert len(mm) == 1
    t0 = base + round(mm[0]["ts"] * 1e3)
    t1 = t0 + round(mm[0]["dur"] * 1e3)
    assert s.start_ns <= t0 <= t1 <= s.end_ns, (s.start_ns - t0, s.end_ns - t1)
    assert mm[0]["tid"] == s.thread
