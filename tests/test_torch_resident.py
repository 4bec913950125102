"""The device-resident store and its train step on the CPU.

``build_resident_store`` gives the JAX package's store exactly (u8 image,
u16 gt, u8 mask, ``gt_scale``; the JAX side on a one-device CPU mesh); the
decode of injected rows equals JAX's (``jnp.take``, ``astype(f32) *
gt_scale``); ``resident_step`` on injected rows equals ``train_step`` on
the same batch decoded on the host; the draw is a pure function of (seed,
step), so a resumed run steps as the uninterrupted one; ``resident_chain(3)``
equals three ``resident_step`` calls; ``fit`` on a store runs with chains
of 1 and 2 steps, logs inside chains, stops between them, and the loss
falls. ``ff_smoke`` at 64^2 in float32; CPU results compare with ``==``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.data.datasets import DepthDataset
from pldepth_torch.data.packed import PackedDataset, pack_dataset
from pldepth_torch.data.resident import (
    BYTES_PER_PIXEL,
    build_resident_store,
    decode_gt,
    estimate_store_bytes,
)
from pldepth_torch.data.scenes import SceneDepthDataset
from pldepth_torch.train import Trainer
from pldepth_torch.train.checkpoint import CheckpointManager
from pldepth_tpu.core.mesh import make_mesh
from pldepth_tpu.data.datasets import DepthDataset as JDepthDataset
from pldepth_tpu.data.resident import build_resident_store as j_build_resident_store

torch.set_num_threads(1)
S = 64
N = 8


def _load(i):
    rng = np.random.default_rng(50 + i)
    return {"image": rng.uniform(size=(S, S, 3)).astype(np.float32),
            "gt": rng.uniform(0.05, 1.0, (S, S)).astype(np.float32),
            "mask": (rng.uniform(size=(S, S)) < 0.9).astype(np.float32)}


@pytest.fixture(scope="module")
def stores():
    ds = DepthDataset("np", N, _load).cached()
    mine = build_resident_store(ds, "cpu")
    theirs = j_build_resident_store(JDepthDataset("np", N, ds.loader),
                                    make_mesh(devices=jax.devices()[:1]))
    return ds, mine, theirs


def _cfg(**kw):
    return ExperimentConfig(**{**dict(
        model_name="ff_smoke", input_size=S, batch_size=4, ranking_size=3, rankings_per_image=8,
        sampling_type=1, freeze_encoder=False, compute_dtype="float32", initial_lr=3e-4,
        epochs=1), **kw})


def _trainer(steps_per_epoch=2, **kw):
    return Trainer(_cfg(**kw), steps_per_epoch=steps_per_epoch, device="cpu")


def _snapshot(state):
    return ([t.detach().clone() for t in state.model.state_dict().values()],
            [t.clone() for t in state.opt.state_dict().values()])


def _assert_same(a, b):
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def test_store_equals_jax(stores):
    _, mine, theirs = stores
    assert mine.n == theirs.n == N and mine.gt_scale == theirs.gt_scale
    got = {k: v.numpy() for k, v in mine.arrays.items()}
    got["gt"] = got["gt"].view(np.uint16)
    for k in ("image", "gt", "mask", "gt_scale"):
        want = np.asarray(theirs.arrays[k])
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    assert mine.arrays["gt"].dtype == torch.int16  # the u16 bits (torch's uint16 is limited)
    assert mine.nbytes == estimate_store_bytes(N, S) + 4 == N * S * S * BYTES_PER_PIXEL + 4


def test_store_limits(stores):
    ds, mine, _ = stores
    with pytest.raises(ValueError, match="max_bytes"):
        build_resident_store(ds, "cpu", max_bytes=mine.nbytes - 5)
    with pytest.raises(NotImplementedError, match="item 11"):
        build_resident_store(ds, "cpu", shard_index=0, num_shards=2)


def test_store_from_a_pack_round_trips_the_images(tmp_path):
    ds = SceneDepthDataset(5, S, seed=4)
    rows = PackedDataset(pack_dataset(ds, str(tmp_path / "s.pldpack")))
    store = build_resident_store(rows, "cpu")
    for i in range(5):
        want = np.clip(ds[i]["image"] * 255.0 + 0.5, 0, 255).astype(np.uint8)  # the pack's bytes
        np.testing.assert_array_equal(store.arrays["image"][i].numpy(), want)
        np.testing.assert_array_equal(store.arrays["mask"][i].numpy(), ds[i]["mask"] > 0)


IDX = [[3, 0, 7, 3], [5, 5, 1, 6]]


@pytest.mark.parametrize("idx", IDX)
def test_resident_decode_equals_jax(stores, idx):
    _, mine, theirs = stores
    tr = _trainer()
    got = tr.resident_batch(tr.init_state(), mine.arrays, torch.tensor(idx))
    ji = jnp.asarray(idx)
    want = {"image": jnp.take(theirs.arrays["image"], ji, axis=0),
            "gt": jnp.take(theirs.arrays["gt"], ji, axis=0).astype(jnp.float32)
            * theirs.arrays["gt_scale"],
            "mask": jnp.take(theirs.arrays["mask"], ji, axis=0)}
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_decode_gt_reads_the_bits_unsigned():
    q = np.array([0, 1, 32767, 32768, 65535], np.uint16)
    got = decode_gt(torch.from_numpy(q.view(np.int16)), torch.tensor(0.5))
    np.testing.assert_array_equal(got.numpy(), q.astype(np.float32) * np.float32(0.5))


def test_resident_step_equals_train_step_on_the_decoded_batch(stores):
    _, mine, _ = stores
    idx = IDX[0]
    host = {"image": mine.arrays["image"].numpy()[idx],
            "gt": (mine.arrays["gt"].numpy().view(np.uint16)[idx].astype(np.float32)
                   * np.float32(mine.gt_scale)),
            "mask": mine.arrays["mask"].numpy()[idx]}
    tr = _trainer()
    a, b = tr.init_state(), tr.init_state()
    a, ma = tr.resident_step(a, mine.arrays, torch.tensor(idx))
    b, mb = tr.train_step(b, host)
    assert a.step == b.step == 1 and bool(ma.finite)
    assert torch.equal(ma.loss, mb.loss)
    _assert_same(_snapshot(a), _snapshot(b))


def test_resident_draw_is_keyed_by_seed_and_step(stores):
    _, mine, _ = stores
    tr = _trainer(batch_size=6)
    st = tr.init_state()
    draws = [tr.resident_batch(st.replace(step=k), mine.arrays)["gt"] for k in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    a, ma = tr.resident_step(tr.init_state(), mine.arrays)
    b, mb = tr.resident_step(tr.init_state(), mine.arrays)
    assert torch.equal(ma.loss, mb.loss)
    _assert_same(_snapshot(a), _snapshot(b))


def test_resident_resume_continues_the_run(stores, tmp_path):
    _, mine, _ = stores
    tr = _trainer()
    full = tr.init_state()
    for _ in range(3):
        full, m_full = tr.resident_step(full, mine.arrays)
    part = tr.init_state()
    part, _ = tr.resident_step(part, mine.arrays)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(part.step, part)
    resumed = mgr.restore(_trainer().init_state())
    assert resumed.step == 1
    for _ in range(2):
        resumed, m_res = tr.resident_step(resumed, mine.arrays)
    assert torch.equal(m_full.loss, m_res.loss)
    _assert_same(_snapshot(full), _snapshot(resumed))


def test_resident_chain_equals_single_steps(stores):
    _, mine, _ = stores
    tr = _trainer()
    a, b = tr.init_state(), tr.init_state()
    a, chain = tr.resident_chain(3)(a, mine.arrays)
    singles = []
    for _ in range(3):
        b, m = tr.resident_step(b, mine.arrays)
        singles.append(m)
    assert chain.loss.shape == chain.lr.shape == chain.finite.shape == (3,)
    assert a.step == b.step == 3
    assert torch.equal(chain.loss, torch.stack([m.loss for m in singles]))
    assert torch.equal(chain.lr, torch.stack([m.lr for m in singles]))
    assert bool(chain.finite.all())
    _assert_same(_snapshot(a), _snapshot(b))
    assert tr.resident_chain(1) == tr.resident_step


class _Log:
    def __init__(self, stop_at=None):
        self.steps, self.stop_at = [], stop_at

    def on_train_begin(self, tr):
        pass

    def on_step_end(self, tr, step, metrics):
        self.steps.append((step, metrics["loss"]))
        if step == self.stop_at:
            tr.request_stop()

    def on_epoch_end(self, tr, st, epoch, history):
        pass

    def on_train_end(self, tr, st, history):
        pass


@pytest.mark.parametrize("chain", [1, 2])
def test_fit_on_a_resident_store(chain):
    ds = SceneDepthDataset(8, S, seed=1)
    tr = _trainer(steps_per_epoch=3, resident_chain_steps=chain, log_every=1,
                  initial_lr=3e-3, batch_size=4, epochs=6)
    store = build_resident_store(ds, "cpu")
    cb = _Log()
    state, history = tr.fit(tr.init_state(), None, callbacks=[cb], resident_store=store)
    assert state.step == 18 and len(history["loss"]) == 6
    assert np.all(np.isfinite(history["loss"])) and np.all(np.array(history["ips"]) > 0)
    assert [s for s, _ in cb.steps] == list(range(18))
    assert history["loss"][-1] < history["loss"][0]
    # one chain of the same steps gives the same losses
    again = _trainer(steps_per_epoch=3, resident_chain_steps=3, initial_lr=3e-3, batch_size=4,
                     epochs=6)
    _, h2 = again.fit(again.init_state(), None, resident_store=store)
    np.testing.assert_array_equal(h2["loss"], history["loss"])


def test_fit_stops_between_chains():
    store = build_resident_store(SceneDepthDataset(8, S, seed=1), "cpu")
    tr = _trainer(steps_per_epoch=6, resident_chain_steps=2, log_every=1, epochs=2)
    cb = _Log(stop_at=2)
    state, history = tr.fit(tr.init_state(), None, callbacks=[cb], resident_store=store)
    assert history.get("preempted") and state.step == 4  # the chain of steps 2-3 ran whole
    assert [s for s, _ in cb.steps] == [0, 1, 2, 3]
