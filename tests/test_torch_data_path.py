"""The training data path on the CPU, against the JAX package.

Every comparison is exact (``==`` on arrays): the port's ``scenes``, its
``BatchIterator`` over every option, the pack files it writes, each
package's ``PackedDataset`` on the other's pack, and the native reader's
batches at the same seed (the same g++ builds both readers, and the epoch
order is ``std::shuffle`` over ``std::mt19937_64(seed)`` in both). Also:
the malformed-file, shape-drift and batch-size errors, a failed reader
build raising with the compiler's output (no fallback), and ``cli train``
on each feed the JAX command has (``--dataset scenes``, ``--uint8_wire``,
``--pack_cache``, ``--data_resident``), one epoch of ``ff_smoke`` at 32^2.
"""

import builtins
import json
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from pldepth_torch.data import packed, scenes
from pldepth_torch.data import io as dio
from pldepth_torch.data.datasets import DepthDataset, get_dataset
from pldepth_torch.data.pipeline import BatchIterator
from pldepth_tpu.data import packed as jpacked
from pldepth_tpu.data import scenes as jscenes
from pldepth_tpu.data.datasets import DepthDataset as JDepthDataset
from pldepth_tpu.data.datasets import get_dataset as j_get_dataset
from pldepth_tpu.data.pipeline import BatchIterator as JBatchIterator

torch.set_num_threads(1)
S = 64


def _load(i, hw=(6, 5)):
    """A numpy sample both packages' datasets can carry unchanged."""
    rng = np.random.default_rng(1000 + i)
    return {"image": rng.uniform(size=hw + (3,)).astype(np.float32),
            "gt": rng.uniform(0.05, 1.0, hw).astype(np.float32),
            "mask": (rng.uniform(size=hw) < 0.8).astype(np.float32)}


def _both(n):
    return DepthDataset("np", n, _load), JDepthDataset("np", n, _load)


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,index", [(0, 0), (0, 5), (3, 1), (7, 12), (1000, 2)])
def test_scene_equals_jax(seed, index):
    got = scenes.SceneDepthDataset(16, S, seed)[index]
    _equal(got, jscenes.SceneDepthDataset(16, S, seed)[index])
    _equal(scenes.generate_scene(index, S, seed), jscenes.generate_scene(index, S, seed))


@pytest.mark.parametrize("seed,index", [(0, 3), (5, 7)])
def test_boundaries_equal_jax(seed, index):
    gt = scenes.generate_scene(index, S, seed)["gt"]
    b = scenes.true_boundary_map(gt)
    assert b.any()
    np.testing.assert_array_equal(b, jscenes.true_boundary_map(gt))
    d = scenes.boundary_distance(gt)
    assert d.dtype == np.float32
    np.testing.assert_array_equal(d, jscenes.boundary_distance(gt))
    flat = np.full((8, 8), 0.3, np.float32)
    np.testing.assert_array_equal(scenes.boundary_distance(flat),
                                  jscenes.boundary_distance(flat))


@pytest.mark.parametrize("split", ["val", "train"])
def test_get_dataset_scenes_equals_jax(split):
    kw = dict(split=split, size=3, target_size=S, seed=2)
    a, b = get_dataset("scenes", **kw), j_get_dataset("scenes", **kw)
    assert len(a) == len(b) == 3
    for i in range(3):
        _equal(a[i], b[i])


@pytest.mark.parametrize("src,hw", [((6, 6), (64, 64)), ((4, 4), (448, 448)),
                                    ((12, 12), (33, 47))])
def test_scene_resize_is_cv2(src, hw):
    x = np.random.default_rng(0).normal(size=src).astype(np.float32)
    want = cv2.resize(x, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(scenes._resize_bilinear(x, hw), want)


def _without(monkeypatch, name):
    real = builtins.__import__

    def imp(mod, *a, **kw):
        if mod.split(".")[0] == name:
            raise ImportError(f"no {name} here")
        return real(mod, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", imp)


def test_scenes_without_cv2_use_the_tf_grid_and_scipy(monkeypatch):
    from scipy.ndimage import distance_transform_edt

    x = np.random.default_rng(1).normal(size=(5, 5)).astype(np.float32)
    gt = scenes.generate_scene(3, S, 0)["gt"]
    _without(monkeypatch, "cv2")
    np.testing.assert_array_equal(scenes._resize_bilinear(x, (S, S)),
                                  dio.resize_bilinear(x, (S, S)))
    want = distance_transform_edt(~scenes.true_boundary_map(gt)).astype(np.float32)
    np.testing.assert_array_equal(scenes.boundary_distance(gt), want)


# --------------------------------------------------------------------------
# BatchIterator
# --------------------------------------------------------------------------

N_DS, BATCH, TAKE = 20, 2, 14  # 20 % 3 != 0: 6 samples a shard, 3 batches


def _drain(it, n=TAKE):
    out = []
    try:
        for _ in range(n):
            out.append(next(it))
    except StopIteration:
        out.append(StopIteration)
    finally:
        it.close()
    return out


@pytest.mark.parametrize("start_step", [0, 3])
@pytest.mark.parametrize("shards", [(0, 1), (0, 3), (1, 3), (2, 3)],
                         ids=lambda s: f"{s[0]}of{s[1]}")
@pytest.mark.parametrize("uint8_wire", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("loop", [True, False], ids=["loop", "once"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "inorder"])
def test_batch_iterator_equals_jax(shuffle, loop, uint8_wire, shards, start_step):
    ds, jds = _both(N_DS)
    kw = dict(seed=5, shuffle=shuffle, loop=loop, shard_index=shards[0], num_shards=shards[1],
              start_step=start_step, uint8_wire=uint8_wire)
    got = _drain(BatchIterator(ds, BATCH, **kw))
    want = _drain(JBatchIterator(jds, BATCH, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is StopIteration:
            assert a is StopIteration
        else:
            _equal(a, b)
            assert a["image"].dtype == (np.uint8 if uint8_wire else np.float32)


def test_batch_iterator_stays_exhausted():
    ds, _ = _both(5)
    it = BatchIterator(ds, 2, loop=False)
    assert len([b for b in it]) == 2
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(it)
    it.close()


@pytest.mark.parametrize("n,batch,shards", [(5, 6, 1), (8, 3, 3), (3, 2, 2)])
def test_batch_iterator_rejects_a_short_dataset(n, batch, shards):
    ds, jds = _both(n)
    for cls, d in ((BatchIterator, ds), (JBatchIterator, jds)):
        with pytest.raises(ValueError, match="cannot fill batch"):
            cls(d, batch, num_shards=shards)


# --------------------------------------------------------------------------
# the packed file and the native reader
# --------------------------------------------------------------------------

N_PACK = 10


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """The same dataset packed by each package."""
    tmp = tmp_path_factory.mktemp("packs")
    ds, jds = _both(N_PACK)
    mine = packed.pack_dataset(ds, str(tmp / "port.pldpack"))
    theirs = jpacked.pack_dataset(jds, str(tmp / "jax.pldpack"))
    return mine, theirs


def test_pack_file_is_byte_identical_to_jax(packs):
    mine, theirs = packs
    assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_packed_datasets_read_each_others_packs(packs):
    mine, theirs = packs
    a, b = packed.PackedDataset(theirs), jpacked.PackedDataset(mine)
    assert len(a) == len(b) == N_PACK
    for i in range(N_PACK):
        _equal(a[i], b[i])
        np.testing.assert_array_equal(a[i]["gt"], _load(i)["gt"])


@pytest.mark.parametrize("uint8_wire,start_step,shuffle,loop", [
    (True, 0, True, True), (False, 0, True, True), (True, 3, True, True),
    (False, 3, True, True), (True, 0, False, False), (False, 2, True, False),
    (True, 5, True, False)])
def test_native_iterator_equals_jax(packs, uint8_wire, start_step, shuffle, loop):
    mine, _ = packs
    kw = dict(seed=11, shuffle=shuffle, loop=loop, uint8_wire=uint8_wire,
              start_step=start_step, workers=2)
    got = _drain(packed.NativePackedIterator(mine, 3, **kw), 9)
    want = _drain(jpacked.NativePackedIterator(mine, 3, **kw), 9)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is StopIteration:
            assert a is StopIteration
        else:
            _equal(a, b)
            assert a["image"].dtype == (np.uint8 if uint8_wire else np.float32)


@pytest.mark.parametrize("uint8_wire", [True, False], ids=["u8", "f32"])
def test_native_batches_are_packed_rows(packs, uint8_wire):
    """In order, the reader's batches are the pack's rows: the same bytes
    (u8 wire), or the bytes times f32(1/255) (f32; PackedDataset divides by
    255, one ulp away at most)."""
    mine, _ = packs
    rows = packed.PackedDataset(mine)
    it = packed.NativePackedIterator(mine, 4, shuffle=False, loop=False, uint8_wire=uint8_wire)
    batches = _drain(it)
    assert batches[-1] is StopIteration and len(batches) == 3  # 10 // 4, then the end
    for b, batch in enumerate(batches[:-1]):
        for j in range(4):
            row = rows[4 * b + j]
            img = np.round(row["image"] * 255.0).astype(np.uint8)
            want = {"image": img if uint8_wire else img * np.float32(1 / 255),
                    "gt": row["gt"],
                    "mask": row["mask"].astype(np.uint8 if uint8_wire else np.float32)}
            _equal({k: v[j] for k, v in batch.items()}, want)


def test_malformed_files_are_rejected(packs, tmp_path):
    good, _ = packs
    bad = {"garbage": b"\x00" * 64, "truncated": open(good, "rb").read()[:200], "empty": b"",
           "magic": b"NOTAPACK" + open(good, "rb").read()[8:]}
    for name, data in bad.items():
        path = tmp_path / f"{name}.pldpack"
        path.write_bytes(data)
        with pytest.raises((ValueError, struct.error)):
            packed.PackedDataset(str(path))
        with pytest.raises(FileNotFoundError):
            packed.NativePackedIterator(str(path), batch_size=2)
    it = packed.NativePackedIterator(good, batch_size=2)
    assert next(it)["image"].shape == (2, 6, 5, 3)
    it.close()


def test_pack_dataset_rejects_shape_drift(tmp_path):
    def load(i):
        return _load(i, (6, 5) if i != 2 else (6, 6))

    with pytest.raises(ValueError, match="sample 2"):
        packed.pack_dataset(DepthDataset("drift", 3, load), str(tmp_path / "bad.pldpack"))


@pytest.mark.parametrize("batch,match", [(0, "batch_size"), (N_PACK + 1, "cannot fill")])
def test_native_iterator_rejects_a_bad_batch(packs, batch, match):
    with pytest.raises(ValueError, match=match):
        packed.NativePackedIterator(packs[0], batch_size=batch)


def test_failed_reader_build_raises_with_the_compiler_output(packs, monkeypatch, tmp_path):
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'packio.cpp:1: error: no such thing' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(packed, "_cxx", lambda: str(fake))
    monkeypatch.setattr(packed, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such thing"):
        packed.NativePackedIterator(packs[0], batch_size=2)
    assert not list((tmp_path / "build").glob("*.so"))


def test_reader_builds_once_per_source(monkeypatch, tmp_path):
    monkeypatch.setattr(packed, "BUILD_DIR", tmp_path)
    path = packed.build_native()
    assert os.path.basename(path) == packed.library_path().name
    assert packed.build_native() == path and len(list(tmp_path.glob("*.so"))) == 1


# --------------------------------------------------------------------------
# cli train on each feed
# --------------------------------------------------------------------------

CLI = ["train", "--device", "cpu", "--model_name", "ff_smoke", "--input_size", "32",
       "--ds_size", "16", "--batch_size", "4", "--epochs", "1", "--ranking_size", "3",
       "--rankings_per_image", "8", "--compute_dtype", "float32", "--run_name", "r"]


def _train(tmp_path, capsys, *flags):
    from pldepth_torch.cli import main

    assert main([*CLI, "--output_dir", str(tmp_path), *flags]) == 0
    out = capsys.readouterr().out
    res = json.loads([ln for ln in out.splitlines() if ln.startswith('{"run_dir"')][-1])
    assert res["step"] == 3 and np.all(np.isfinite(res["loss"]))
    assert os.path.exists(os.path.join(tmp_path, "r", "weights.npz"))
    return out


@pytest.mark.parametrize("flags", [["--dataset", "scenes"], ["--uint8_wire", "true"],
                                   ["--data_resident", "true", "--resident_chain_steps", "2"]],
                         ids=["scenes", "uint8_wire", "resident"])
def test_cli_train_runs_on_each_feed(flags, tmp_path, capsys):
    out = _train(tmp_path, capsys, *flags)
    if "--data_resident" in flags:
        assert "resident store: 15 samples, 0.00 GB in HBM" in out


def test_cli_train_from_a_pack_cache(tmp_path, capsys):
    pack = str(tmp_path / "train.pldpack")
    out = _train(tmp_path / "a", capsys, "--dataset", "scenes", "--pack_cache", pack)
    assert f"packing 15 samples -> {pack}" in out
    ds = get_dataset("scenes", size=16, seed=0, target_size=32).skip(1)
    rows = packed.PackedDataset(pack)
    assert len(rows) == 15
    np.testing.assert_array_equal(rows[4]["gt"], ds[4]["gt"])
    before = open(pack, "rb").read()
    out = _train(tmp_path / "b", capsys, "--dataset", "scenes", "--pack_cache", pack)
    assert "packing" not in out and open(pack, "rb").read() == before
