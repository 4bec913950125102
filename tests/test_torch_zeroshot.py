"""The port's zero-shot sets, DIW and nearest resize against the JAX package.

* The four loaders (Ibims .mat, TUM .h5, DIODE png + npy, Sintel png) on the
  same tiny trees as tests/test_zero_shot_daos.py: shapes, masks and
  ``asc_depth_order`` equal; image and gt within 2e-4 of JAX's, relative to
  the map's largest value (the two packages resize on their own hosts, cv2
  against torch: tests/test_torch_resize.py). Measured here: at most 1.7e-6
  of the largest value (Sintel's gt, 0-255: 3.9e-4 absolute).
* DIW: ``load_diw`` gives the same items and pairs on the official layout
  and on the multi-pair / missing-image fixture of tests/test_diw.py;
  ``evaluate_diw`` gives the known answer (2/5) and JAX's dict.
* ``resize_nearest`` equals ``jax.image.resize(..., "nearest")``.
* ``cli zeroshot`` on an Ibims root and a DIW root, and with no root.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pldepth_torch.data import datasets as PD
from pldepth_torch.data.diw import load_diw
from pldepth_torch.eval.diw import _scaled_pairs, evaluate_diw
from pldepth_torch.ops.resize import resize_nearest
from pldepth_tpu.data import datasets as JDS
from pldepth_tpu.data.diw import load_diw as j_load_diw
from pldepth_tpu.eval.diw import _scaled_pairs as j_scaled_pairs, evaluate_diw as j_evaluate_diw
from pldepth_tpu.ops.resize import resize_nearest as j_resize_nearest

torch.set_num_threads(1)
S = 24  # source size; loaders resize to target


def _ibims(root, n=2, shape=(S, S)):
    from scipy import io as sio

    rng = np.random.default_rng(0)
    for i in range(n):
        # reference layout: data struct, image at field 2, depth at field 3
        data = np.zeros((1, 1), dtype=[("a", "O"), ("b", "O"), ("rgb", "O"), ("depth", "O")])
        data[0, 0]["a"] = np.zeros(1)
        data[0, 0]["b"] = np.zeros(1)
        data[0, 0]["rgb"] = rng.uniform(0, 255, (*shape, 3)).astype(np.float32)
        data[0, 0]["depth"] = rng.uniform(0.5, 10, shape).astype(np.float32)
        sio.savemat(os.path.join(root, f"im_{i}.mat"), {"data": data})


def _tum(root):
    import h5py

    rng = np.random.default_rng(1)
    for i in range(2):
        with h5py.File(os.path.join(root, f"t_{i}.h5"), "w") as f:
            g = f.create_group("gt")
            g["img_1"] = rng.uniform(0, 255, (S, S, 3)).astype(np.float32)
            g["pp_depth"] = rng.uniform(0.5, 5, (S, S)).astype(np.float32)


def _diode(root):
    rng = np.random.default_rng(2)
    d = os.path.join(root, "val", "indoors", "scene_1")
    os.makedirs(d)
    for i in range(2):
        img = rng.uniform(0, 255, (S, S, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(d, f"{i:05d}.png"))
        np.save(os.path.join(d, f"{i:05d}_depth.npy"),
                rng.uniform(0.5, 8, (S, S, 1)).astype(np.float32))


def _sintel(root, gray=False):
    rng = np.random.default_rng(3)
    imgs = os.path.join(root, "images", "alley_1")
    viz = os.path.join(root, "depth_viz", "alley_1")
    os.makedirs(imgs)
    os.makedirs(viz)
    for i in range(2):
        img = rng.uniform(0, 255, (S, S) if gray else (S, S, 3)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(imgs, f"frame_{i:04d}.png"))
        Image.fromarray(rng.uniform(0, 255, (S, S)).astype(np.uint8)).save(
            os.path.join(viz, f"frame_{i:04d}.png"))


@pytest.mark.parametrize("name,write", [("IBIMS", _ibims), ("TUM", _tum), ("DIODE", _diode),
                                        ("SINTEL", _sintel)])
@pytest.mark.parametrize("target", [16, 40])
def test_zero_shot_loaders_match_jax(tmp_path, name, write, target):
    write(str(tmp_path))
    ds = PD.get_dataset(name, root=str(tmp_path), target_size=target)
    jds = JDS.get_dataset(name, root=str(tmp_path), target_size=target)
    assert (ds.name, len(ds), ds.asc_depth_order) == (jds.name, len(jds), True) == (
        name.lower(), 2, True)
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert set(got) == set(want) == {"image", "gt", "mask"}
        for k in got:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype == np.float32
        assert got["image"].shape == (target, target, 3)
        assert np.array_equal(got["mask"], want["mask"]) and np.all(got["mask"] == 1.0)
        for k in ("image", "gt"):
            scale = float(np.abs(want[k]).max())
            assert float(np.abs(got[k] - want[k]).max()) <= 2e-4 * scale, k
    if name == "SINTEL":  # depth_viz values are rescaled x255 (sintel.py:31)
        assert ds[0]["gt"].max() > 1.5


def test_gray_images_repeat_to_three_channels(tmp_path):
    _sintel(str(tmp_path), gray=True)
    got = PD.load_sintel(str(tmp_path), target_size=16)[0]["image"]
    want = JDS.load_sintel(str(tmp_path), target_size=16)[0]["image"]
    assert got.shape == want.shape == (16, 16, 3)
    assert np.array_equal(got[..., 0], got[..., 2])
    assert float(np.abs(got - want).max()) <= 2e-4


def test_ibims_reader_scales_images_as_jax(tmp_path):
    from pldepth_torch.data.io import read_h5_tum, read_mat_ibims, read_npy_depth
    from pldepth_tpu.data import io as jio

    _ibims(str(tmp_path), n=1)
    _tum(str(tmp_path))
    for got, want in ((read_mat_ibims(str(tmp_path / "im_0.mat")),
                       jio.read_mat_ibims(str(tmp_path / "im_0.mat"))),
                      (read_h5_tum(str(tmp_path / "t_0.h5")),
                       jio.read_h5_tum(str(tmp_path / "t_0.h5")))):
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
        assert got[0].max() <= 1.0
    np.save(tmp_path / "d.npy", np.ones((3, 4, 1), np.float64))
    d = read_npy_depth(str(tmp_path / "d.npy"))
    assert d.shape == (3, 4) and d.dtype == np.float32


# -- DIW ------------------------------------------------------------------------
def _write_jpg(path, arr_u8):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr_u8).save(path, quality=95)


def _fake_tree(root, n_images=3, size=(40, 60)):
    """Official DIW layout: DIW_test.csv + relative image paths
    (tests/test_diw.py)."""
    h, w = size
    lines = []
    rng = np.random.default_rng(0)
    for i in range(n_images):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        rel_path = f"DIW_test/{i:03d}.jpg"
        _write_jpg(os.path.join(root, rel_path), img)
        lines.append("/" + rel_path)
        rel = ">" if i % 2 == 0 else "<"
        lines.append(f"5,7,30,50,{rel},{w},{h}")
    with open(os.path.join(root, "DIW_test.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _same_items(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.image_path, a.orig_size) == (b.image_path, b.orig_size)
        assert a.pairs.dtype == b.pairs.dtype and np.array_equal(a.pairs, b.pairs)


def test_load_diw_official_layout_equals_jax(tmp_path):
    _fake_tree(str(tmp_path), n_images=3)
    items = load_diw(str(tmp_path))
    _same_items(items, j_load_diw(str(tmp_path)))
    np.testing.assert_array_equal(items[0].pairs[0], [4, 6, 29, 49, 1])  # 1- -> 0-indexed
    assert items[1].pairs[0, 4] == -1.0 and items[0].orig_size == (60, 40)


def test_load_diw_multi_pair_and_missing_images_equal_jax(tmp_path):
    _fake_tree(str(tmp_path), n_images=2)
    with open(tmp_path / "DIW_test.csv", "a") as f:
        f.write("/DIW_test/000.jpg\n2,2,3,3,<\n")
        f.write("/DIW_test/missing.jpg\n1,1,2,2,>\n")
    items = load_diw(str(tmp_path))
    _same_items(items, j_load_diw(str(tmp_path)))
    assert len(items) == 2 and items[0].pairs.shape == (2, 5)
    with pytest.raises(FileNotFoundError):
        load_diw(str(tmp_path / "nowhere"))


def test_scaled_pairs_round_half_to_even():
    pairs = np.array([[1, 3, 5, 7, 1], [0.5, 2.5, 39, 59, -1]], np.float32)
    got = _scaled_pairs(pairs, (40, 60), 20)
    assert np.array_equal(got, j_scaled_pairs(pairs, (40, 60), 20))
    assert got[0, :4].tolist() == [0, 1, 2, 2]  # 0.5 -> 0, 1.5 -> 2 (half to even)


class _RedChannel:
    """predict = red channel of the input: a depth map we fully control."""

    def jit_predict(self):
        return lambda _state, images: np.asarray(images)[..., 0:1]


def test_evaluate_diw_known_answer_equals_jax(tmp_path):
    """A horizontal gradient (closeness grows with x), A left of B: the model
    sees A farther, agreeing with '>' labels and not with '<' (2 of 5)."""
    h, w = 32, 48
    grad = np.tile(np.linspace(0, 255, w, dtype=np.uint8), (h, 1))
    os.makedirs(tmp_path / "imgs")
    lines = []
    for i, rel in enumerate([">", "<", ">", "<", ">"]):
        Image.fromarray(np.stack([grad] * 3, -1)).save(tmp_path / f"imgs/{i}.png")
        lines += [f"/imgs/{i}.png", f"10,5,20,40,{rel}"]
    (tmp_path / "DIW_test.csv").write_text("\n".join(lines) + "\n")
    items = load_diw(str(tmp_path))
    out = evaluate_diw(_RedChannel(), None, items, input_size=32, batch_size=2)
    assert out == {"diw_whdr": 2 / 5, "n_pairs": 5, "n_images": 5, "n_predicted_ties": 0}
    assert out == j_evaluate_diw(_RedChannel(), None, j_load_diw(str(tmp_path)), input_size=32,
                                 batch_size=2)
    # a flat image: every prediction ties, and ties disagree with both labels
    for i in range(5):
        Image.fromarray(np.full((h, w, 3), 7, np.uint8)).save(tmp_path / f"imgs/{i}.png")
    flat = evaluate_diw(_RedChannel(), None, items, input_size=32)
    assert flat == {"diw_whdr": 1.0, "n_pairs": 5, "n_images": 5, "n_predicted_ties": 5}
    assert flat == j_evaluate_diw(_RedChannel(), None, items, input_size=32)


# -- nearest resize ---------------------------------------------------------------
@pytest.mark.parametrize("shape,size,channel_last", [
    ((7, 5), (3, 4), True), ((7, 5), (10, 12), True), ((7, 5), (4, 2), True),
    ((9, 6, 3), (4, 5), True), ((9, 6, 3), (20, 13), True),
    ((2, 9, 6, 3), (5, 7), True), ((2, 9, 6, 3), (17, 11), True),
    ((3, 9, 6), (4, 5), False), ((3, 9, 6), (19, 14), False),
])
def test_resize_nearest_equals_jax(shape, size, channel_last):
    x = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    got = resize_nearest(torch.from_numpy(x), size, channel_last=channel_last).numpy()
    want = np.asarray(j_resize_nearest(jnp.asarray(x), size, channel_last=channel_last))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


# -- cli zeroshot -----------------------------------------------------------------
@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import save_weights_npz

    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=32), device="cpu")
    path = str(tmp_path_factory.mktemp("zw") / "weights.npz")
    save_weights_npz(path, tr.init_state())
    return path


def test_cli_zeroshot_ibims_and_diw(tmp_path, weights, capsys):
    from pldepth_torch.cli import main
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.eval import Evaluator
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import load_weights_npz

    os.makedirs(tmp_path / "ibims")
    _ibims(str(tmp_path / "ibims"), n=3, shape=(30, 40))
    _fake_tree(str(tmp_path / "diw"), n_images=4, size=(48, 48))
    assert main(["zeroshot", "--device", "cpu", "--model_name", "ff_smoke", "--load_model_path",
                 weights, "--input_size", "32", "--ibims_root", str(tmp_path / "ibims"),
                 "--diw_root", str(tmp_path / "diw")]) == 0
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"ibims", "diw"}
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=32), device="cpu")
    state = load_weights_npz(weights, tr.init_state())
    ds = PD.load_ibims(str(tmp_path / "ibims"), target_size=32)
    assert out["ibims"] == Evaluator(tr, state).zero_shot_suite([ds])["ibims"]
    assert set(out["diw"]) == {"diw_whdr", "n_pairs", "n_images", "n_predicted_ties"}
    assert (out["diw"]["n_pairs"], out["diw"]["n_images"]) == (4, 4)
    assert 0.0 <= out["diw"]["diw_whdr"] <= 1.0


def test_cli_zeroshot_without_a_root_is_a_usage_error(weights, capsys):
    from pldepth_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main(["zeroshot", "--device", "cpu", "--model_name", "ff_smoke",
              "--load_model_path", weights])
    assert e.value.code == 2
    assert "provide at least one dataset root" in capsys.readouterr().err
