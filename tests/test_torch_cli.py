"""``python -m pldepth_torch.cli predict --device cpu --fused_encoder true``
on three PNGs with a ``weights.npz`` the JAX package wrote: its depth maps
match the JAX package's ``predict_fused`` on the same images within the
bf16 serving bound (rel <= 0.03, tests/test_fused_infer.py). The two
packages decode and resize the PNGs on their own hosts (cv2 vs torch, gap
<= 2e-4 per pixel, tests/test_torch_resize.py)."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from PIL import Image

from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.core.mesh import make_mesh
from pldepth_tpu.serve.pipeline import decode_image_chunk
from pldepth_tpu.train import Trainer as JTrainer
from pldepth_tpu.train.checkpoint import save_weights_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    imgs = root / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    files = []
    for i in range(3):
        path = str(imgs / f"im{i}.png")
        Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(path)
        files.append(path)
    cfg = JConfig(model_name="ff_smoke", input_size=SIZE)
    tr = JTrainer(cfg, steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
    state = tr.init_state()
    weights = str(root / "weights.npz")
    save_weights_npz(weights, state)
    want = np.asarray(jax.jit(tr.predict_fused)(state, decode_image_chunk(files, SIZE)),
                      np.float32)
    return root, imgs, weights, files, want


def _run(*args):
    return subprocess.run(
        [sys.executable, "-m", "pldepth_torch.cli", "predict", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_cli_predict_fused_matches_jax(served):
    root, imgs, weights, files, want = served
    out = root / "out"
    r = _run("--model_name", "ff_smoke", "--load_model_path", weights,
             "--inputs", str(imgs), "--out_dir", str(out), "--input_size", str(SIZE),
             "--batch_size", "2", "--device", "cpu", "--fused_encoder", "true")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"n": 3, "out_dir": str(out)}
    for i, f in enumerate(files):
        d = np.load(out / f"im{i}_depth.npy")
        assert d.shape == (SIZE, SIZE) and np.isfinite(d).all()
        rel = np.abs(d - want[i]).max() / np.abs(want[i]).max()
        assert rel <= 0.03, (f, rel)
        assert (out / f"im{i}_depth.png").exists()  # --save_png defaults to true


def test_cli_default_mode_names_its_roadmap_item(served):
    """The default flags select int8 serving (calibrated on the first
    chunk): its maps track the JAX float serving graph within the int8
    bound of tests/test_quantize.py (rel < 0.15, pearson > 0.98)."""
    root, imgs, weights, files, want = served
    out = root / "o2"
    r = _run("--model_name", "ff_smoke", "--load_model_path", weights,
             "--inputs", str(imgs), "--out_dir", str(out), "--input_size", str(SIZE),
             "--device", "cpu")
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"n": 3, "out_dir": str(out)}
    for i in range(len(files)):
        d = np.load(out / f"im{i}_depth.npy")
        assert d.shape == (SIZE, SIZE) and np.isfinite(d).all()
        rel = np.abs(d - want[i]).max() / np.abs(want[i]).max()
        assert rel < 0.15 and np.corrcoef(d.ravel(), want[i].ravel())[0, 1] > 0.98, (i, rel)


def test_cli_predict_profile_dir_traces_the_serving_spans(served):
    """--profile_dir: a Chrome trace of the serving loop with each chunk's
    spans, the upload under its serve.infer, the queue's wait on a track of
    its own."""
    root, imgs, weights, files, want = served
    out, prof = root / "o3", root / "prof"
    r = _run("--model_name", "ff_smoke", "--load_model_path", weights,
             "--inputs", str(imgs), "--out_dir", str(out), "--input_size", str(SIZE),
             "--batch_size", "2", "--device", "cpu", "--profile_dir", str(prof))
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == {"n": 3, "out_dir": str(out)}
    (trace,) = prof.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    for chunk in (0, 1):
        mine = {e["name"]: e for e in spans if e["args"]["ident"] == chunk}
        assert set(mine) == {"serve.queue", "serve.infer", "upload", "serve.wait",
                             "serve.write_wait"}, (chunk, sorted(mine))
        assert mine["upload"]["args"]["parent"] == mine["serve.infer"]["args"]["id"]
        assert mine["serve.queue"]["tid"] == 0
        assert mine["serve.infer"]["tid"] == mine["serve.wait"]["tid"] != 0
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::convolution" for e in events)
