"""What the one-card step graph (train/trainer.py) rests on, on the CPU.

The graph itself runs only on the card (tests/test_torch_cuda.py: graphed
steps equal eager steps bit for bit, fit's counters, no host sync, the
profiler). Here: the LR schedules and the decoder tail's constants make no
device tensor from a host value once they have run, and return today's
values bit for bit; a persistent generator re-seeded to a step draws what
that step's fresh generator draws (flip, sampler, drop-path); the graph's
key changes with a new state, a restore, a new batch shape or dtype, and
not over steps; the capture and replay logic, with stand-ins for the CUDA
graph, captures once a key after one eager step and replays after, and the
kernel wrappers' counters count each replay's launches and not the
capture's.
"""

import contextlib
import math

import numpy as np
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.core.device import Constants
from pldepth_torch.core.mesh import batch_rand
from pldepth_torch.core.rng import generator
from pldepth_torch.data.datasets import SyntheticDepthDataset
from pldepth_torch.data.pipeline import BatchIterator
from pldepth_torch.models.layers import TrainPass
from pldepth_torch.ops import fused_tail
from pldepth_torch.train import schedules
from pldepth_torch.train.trainer import STEP_DRAWS, Trainer


# --- the schedules as they were: a device tensor made from each constant
# at every call (the values the cached constants must give bit for bit)

def _f32(step):
    return torch.as_tensor(step).to(torch.float32)


def _sgdr_before(max_lr, min_lr, steps_per_cycle, lr_decay=1.0, mult_factor=1.0):
    def schedule(step):
        t = _f32(step)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=t.device)  # noqa: E731
        l0 = f32(steps_per_cycle)
        if mult_factor == 1.0:
            cycle = torch.floor(t / l0)
            frac = (t - cycle * l0) / l0
        else:
            m = f32(mult_factor)
            cycle = torch.floor(torch.log1p(t * (m - 1.0) / l0) / torch.log(m))
            start = l0 * (torch.pow(m, cycle) - 1.0) / (m - 1.0)
            length = l0 * torch.pow(m, cycle)
            frac = (t - start) / length
        frac = torch.clamp(frac, 0.0, 1.0)
        peak = f32(max_lr) * torch.pow(f32(lr_decay), cycle)
        return f32(min_lr) + 0.5 * (peak - f32(min_lr)) * (1.0 + torch.cos(frac * math.pi))

    return schedule


def _step_decay_before(init_lr, steps_per_epoch, milestones=(80, 120, 160, 180),
                       multiplier=0.1, warmup_epochs=0):
    ms = sorted(milestones)

    def schedule(step):
        epoch = _f32(step) / float(steps_per_epoch)
        msv = torch.tensor(ms, dtype=torch.float32, device=epoch.device)
        n_hit = (epoch >= msv).sum().to(torch.float32)
        lr = torch.tensor(init_lr, dtype=torch.float32, device=epoch.device) * torch.pow(
            torch.tensor(multiplier, dtype=torch.float32, device=epoch.device), n_hit)
        if warmup_epochs > 0:
            warm = (torch.floor(epoch) + 1.0) * init_lr / float(warmup_epochs)
            lr = torch.where(epoch < warmup_epochs, warm, lr)
        return lr

    return schedule


SCHEDULES = [
    ("sgdr", dict(max_lr=0.01, min_lr=0.0025, steps_per_cycle=37), 37),
    ("sgdr", dict(max_lr=0.01, min_lr=0.0025, steps_per_cycle=37, lr_decay=0.7), 37),
    ("sgdr", dict(max_lr=0.1, min_lr=0.001, steps_per_cycle=13, lr_decay=0.5,
                  mult_factor=2.0), 13),
    ("sgdr", dict(max_lr=0.01, min_lr=0.0, steps_per_cycle=637, mult_factor=2.0), 637),
    ("step", dict(init_lr=0.01, steps_per_epoch=3, milestones=(2, 5, 9), multiplier=0.25,
                  warmup_epochs=2), 15),
    ("step", dict(init_lr=0.05, steps_per_epoch=7, milestones=(), multiplier=0.1), 20),
]


def _pair(kind, kw):
    if kind == "sgdr":
        return schedules.sgdr_schedule(**kw), _sgdr_before(**kw)
    return schedules.step_decay_schedule(**kw), _step_decay_before(**kw)


@pytest.mark.parametrize("kind,kw,cycle", SCHEDULES)
@pytest.mark.parametrize("counter", ["int", "int32 tensor"])
def test_schedules_return_todays_values_bit_for_bit(kind, kw, cycle, counter):
    new, old = _pair(kind, kw)
    for step in range(2 * cycle + 1):
        s = step if counter == "int" else torch.tensor(step, dtype=torch.int32)
        got, want = new(s), old(s)
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want), (step, float(got), float(want))


def test_constant_schedule_returns_todays_value():
    sched = schedules.constant_schedule(0.0123)
    for s in (0, 5, torch.tensor(9, dtype=torch.int32)):
        assert torch.equal(sched(s), torch.tensor(0.0123, dtype=torch.float32))


def _no_new_tensors(monkeypatch):
    """``torch.tensor`` and ``torch.as_tensor`` refuse host values (a
    tensor given to ``as_tensor`` stays as it is)."""
    as_tensor = torch.as_tensor

    def refuse(data, *a, **k):
        if isinstance(data, torch.Tensor) and not a and not k:
            return as_tensor(data)
        raise AssertionError(f"a tensor made from a host value: {data!r}")

    for name in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse)


@pytest.mark.parametrize("kind,kw,cycle", SCHEDULES)
def test_a_schedule_makes_no_tensor_from_a_host_value_after_its_first_call(
        kind, kw, cycle, monkeypatch):
    """The optimizer calls its schedule on the device counter: past the
    first call no constant is copied to the device, so the call waits for
    nothing and can be captured."""
    new, _ = _pair(kind, kw)
    count = torch.zeros((), dtype=torch.int32)
    first = new(count)
    _no_new_tensors(monkeypatch)
    assert torch.equal(new(count), first)
    new(count + cycle)


def test_the_fused_tail_kernel_makes_no_host_to_device_copy_after_its_first_call(
        monkeypatch):
    w = torch.randn(3, 5, 3, 3)
    first = fused_tail.compose_upsample_conv_kernel(w)
    _no_new_tensors(monkeypatch)
    assert torch.equal(fused_tail.compose_upsample_conv_kernel(w), first)


def test_device_constants_are_made_once_and_outside_inference_mode():
    c = Constants((1.5, 2.5))
    x = torch.ones(2, requires_grad=True)
    with torch.inference_mode():  # a prediction makes them first
        made = c.like(x.detach())
    assert c.like(x) is made and not made.is_inference()
    (x * c.like(x)).sum().backward()  # a train step may save them
    assert torch.equal(x.grad, torch.tensor([1.5, 2.5]))
    wide = c.like(x.double())
    assert wide.dtype == torch.float64 and wide is not made and c.like(x.double()) is wide


# --- the step's generators ------------------------------------------------

def _cfg(**kw):
    return ExperimentConfig(**{**dict(model_name="ff_smoke", input_size=64, batch_size=2,
                                      ranking_size=5, rankings_per_image=20,
                                      freeze_encoder=True), **kw})


def _batch(batch=2, size=64, seed=0, image_dtype=np.float32):
    rng = np.random.default_rng(seed)
    image = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    if image_dtype == np.uint8:
        image = (image * 255).astype(np.uint8)
    return {"image": image,
            "gt": rng.uniform(0.1, 1.0, size=(batch, size, size)).astype(np.float32),
            "mask": (rng.uniform(size=(batch, size, size)) > 0.2).astype(np.float32)}


def test_a_reseeded_generator_draws_what_the_steps_fresh_generator_draws():
    """Flip, sampler and drop-path draw from one persistent generator each
    while the graph is captured; re-seeded to a step, each draws what that
    step's fresh ``generator(seed, "train/<tag>", step)`` draws, again
    after it has drawn for another step."""
    # ff_effnet: B0's residual blocks draw drop-path (ff_smoke has none)
    trainer = Trainer(_cfg(model_name="ff_effnet", augmentation=True), device="cpu")
    state = trainer.init_state().replace(seed=12345)
    trainer._draws = {tag: torch.Generator() for tag in STEP_DRAWS}
    b = trainer._to_device(_batch())
    x = torch.randn(8, 32, 32, 3)
    fwds = []
    for step in (0, 3, 1, 3):
        st = state.replace(step=step)
        want_img, want_rk = trainer._rankings(st, b)
        want_drop = batch_rand(trainer._gen(st, "droppath"), (16,))
        want_fwd = st.model(x, TrainPass(gen=trainer._gen(st, "droppath")))
        trainer._reseed(st)
        trainer._capturing = True
        try:
            img, rk = trainer._rankings(st, b)
            fwd = st.model(x, TrainPass(gen=trainer._gen(st, "droppath")))
            trainer._reseed(st)
            drop = batch_rand(trainer._gen(st, "droppath"), (16,))
        finally:
            trainer._capturing = False
        assert torch.equal(img, want_img) and torch.equal(rk, want_rk)
        assert torch.equal(drop, want_drop) and torch.equal(fwd, want_fwd)
        fwds.append(fwd)
        fresh = generator(12345, "train/flip", step)
        trainer._reseed(st)
        assert torch.equal(torch.rand(8, generator=trainer._draws["flip"]),
                           torch.rand(8, generator=fresh))
    # the draws reach the forward: another step's key, another map
    assert not torch.equal(fwds[0], fwds[1]) and torch.equal(fwds[1], fwds[3])


# --- the graph's key --------------------------------------------------------

def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_the_graph_key_holds_over_steps_and_fits_and_changes_with_the_state_or_batch():
    trainer = Trainer(_cfg(), steps_per_epoch=3, device="cpu")
    state = trainer.init_state()
    batch = _tensors(_batch())
    key = trainer._graph_key(state, batch)
    it = BatchIterator(SyntheticDepthDataset(8, 64, 0), 2, seed=0)
    try:
        state, _ = trainer.fit(state, it, epochs=1)
        assert trainer._graph_key(state, batch) == key  # updated in place
        state, _ = trainer.fit(state, it, epochs=2)  # a second fit, the same state
    finally:
        it.close()
    assert state.step == 6 and trainer._graph_key(state, batch) == key
    assert trainer._graph_key(trainer.init_state(), batch) != key
    assert trainer._graph_key(state, _tensors(_batch(batch=3))) != key
    assert trainer._graph_key(state, _tensors(_batch(image_dtype=np.uint8))) != key
    # a restore that assigns new tensors
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    state.model.load_state_dict(sd, assign=True)
    assert trainer._graph_key(state, batch) != key


@pytest.mark.parametrize("qenc", ["bf16", "int8"])
def test_the_graph_key_follows_the_int8_encoder_and_not_the_bf16_one(qenc):
    """``qenc="bf16"`` folds its encoder from the module at the first step:
    the key stays, so the graph captured after that step is kept as without
    qenc. ``"int8"``'s encoder comes from ``prepare_qenc``: a new one asks
    for a new capture."""
    trainer = Trainer(_cfg(qenc=qenc), steps_per_epoch=4, device="cpu")
    state = trainer.init_state()
    batch = _batch()
    if qenc == "int8":
        trainer.prepare_qenc(state, batch["image"])
    key = trainer._graph_key(state, _tensors(batch))
    state, _ = trainer.train_step(state, batch)
    assert trainer._qenc is not None and trainer._graph_key(state, _tensors(batch)) == key
    if qenc == "int8":
        trainer.prepare_qenc(state, batch["image"])
        assert trainer._graph_key(state, _tensors(batch)) != key


# --- the capture and replay logic, with stand-ins for the CUDA graph ------

class _FakeGraph:
    replays = 0

    def register_generator_state(self, gen):
        assert isinstance(gen, torch.Generator)

    def replay(self):
        _FakeGraph.replays += 1


class _FakeStream:
    def __init__(self, *args):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """Stand-ins that capture by running the step and replay nothing: the
    step graph's decisions on the CPU."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(Trainer, "_graphed", lambda self: True)
    _FakeGraph.replays = 0


def test_a_key_runs_one_eager_step_then_one_capture_then_replays(fake_graphs):
    trainer = Trainer(_cfg(), steps_per_epoch=8, device="cpu")
    state = trainer.init_state()
    counts = []
    for i in range(5):
        state, m = trainer.train_step(state, _batch(seed=i))
        counts.append((trainer.graph_captures, trainer.graph_replays))
        if trainer.graph_replays:  # fresh copies: the graph's outputs never escape
            assert m.loss is not trainer._graph.loss and m.finite is not trainer._graph.finite
    assert counts == [(1, 0), (1, 1), (1, 2), (1, 3), (1, 4)]
    assert _FakeGraph.replays == 4 and state.step == 5
    assert set(trainer._draws) == set(STEP_DRAWS)
    # a new batch shape: its first step eagerly as the warm-up, then a new
    # capture
    for i in range(3):
        state, _ = trainer.train_step(state, _batch(batch=3, seed=i))
    assert (trainer.graph_captures, trainer.graph_replays) == (2, 6)
    # a new state likewise
    other = trainer.init_state()
    for i in range(3):
        other, _ = trainer.train_step(other, _batch(batch=3, seed=i))
    assert (trainer.graph_captures, trainer.graph_replays) == (3, 8)


def test_the_launch_counters_count_every_step_and_not_the_capture(fake_graphs, monkeypatch):
    """A replay launches the captured kernels without calling their
    wrappers: it adds the capture's counts, and the capture, which
    launches nothing, adds none. Here a stand-in for K1's fused forward
    counts on the CPU path's loss."""
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.train import trainer as trainer_mod

    loss = trainer_mod.pl_ranking_loss

    def counted(*args, **kwargs):
        k1.ranking_loss_fwd.launches += 2
        return loss(*args, **kwargs)

    monkeypatch.setattr(trainer_mod, "pl_ranking_loss", counted)
    monkeypatch.setattr(k1.ranking_loss_fwd, "launches", 7)
    trainer = Trainer(_cfg(), steps_per_epoch=8, device="cpu")
    state = trainer.init_state()
    seen = []
    for i in range(4):
        state, _ = trainer.train_step(state, _batch(seed=i))
        seen.append(k1.ranking_loss_fwd.launches)
    assert seen == [9, 11, 13, 15]
    assert trainer._graph.launches == (((k1.ranking_loss_fwd, "launches"), 2),)
    assert (trainer.graph_captures, trainer.graph_replays) == (1, 3)


class _Mesh:
    active, data, data_index, model = True, 2, 0, 1


def test_the_graph_runs_on_a_card_without_a_process_group_or_remat():
    """The rule reads what the trainer can observe: the device, the
    process group, ``remat_encoder``; no switch, no model name."""
    def graphed(device, **kw):
        trainer = Trainer(_cfg(**kw), device="cpu")
        trainer.device = torch.device(device)
        return trainer

    assert graphed("cuda")._graphed()
    assert graphed("cuda", model_name="ff_redweb")._graphed()
    assert graphed("cuda", qres="int8", grad_accum=2, sparse_tail=True)._graphed()
    assert not graphed("cpu")._graphed()
    assert not graphed("cuda", remat_encoder=True)._graphed()
    group = graphed("cuda")
    group.mesh = _Mesh()
    assert not group._graphed()
