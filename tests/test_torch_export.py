"""Export and artifact serving of the port (serve/export.py, ``cli export``,
``cli serve --artifact``) against the JAX package's export, on the CPU.

``ff_smoke`` at 64^2 with the JAX package's initial weights carried across
by the weight bridge: the port's artifact gives the maps of the JAX
artifact (``jax.export``, ``platforms=("cpu",)``) within rel 1e-4 in f32
and 3e-2 in bf16 (tests/test_export.py's bound); a polymorphic artifact
serves batches 1, 3 and 5, a fixed-batch one refuses any other batch; the
metadata has the JAX keys; an artifact loads in a process that never
imports the model code; a JAX artifact is refused by name; ``cli export``
then ``cli serve --artifact`` writes the maps ``cli serve
--load_model_path --quantize ''`` writes.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.models.pretrained import load_flat
from pldepth_torch.serve.daemon import artifact_infer
from pldepth_torch.serve.export import export_predict, load_exported
from pldepth_torch.train import Trainer
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.core.mesh import make_mesh
from pldepth_tpu.serve import export_predict as j_export_predict
from pldepth_tpu.serve import load_exported as j_load_exported
from pldepth_tpu.train import Trainer as JTrainer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _flat(jstate):
    tree = {"params": jax.device_get(jstate.params),
            "batch_stats": jax.device_get(jstate.batch_stats)}
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float32) - b).max() / max(np.abs(b).max(), 1e-9))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request, tmp_path_factory):
    """The same weights in both packages, in one compute dtype, and their
    artifacts: JAX and port at fixed batch 2 with and without bn_fold,
    and the port's polymorphic bn_fold one."""
    dt = request.param
    root = tmp_path_factory.mktemp(f"export_{dt}")
    jtr = JTrainer(JConfig(model_name="ff_smoke", input_size=S, compute_dtype=dt),
                   steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = jtr.init_state()
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=S, compute_dtype=dt),
                 device="cpu")
    state = tr.init_state()
    loaded, skipped = load_flat(state.model, _flat(jstate))
    assert skipped == 0 and loaded == len(state.model.state_dict())
    paths = {}
    for fold in (True, False):
        paths["jax", fold] = j_export_predict(jtr, jstate, 2, str(root / f"j{fold}.plx"),
                                              platforms=("cpu",), bn_fold=fold)
        paths["port", fold] = export_predict(tr, state, 2, str(root / f"t{fold}.plx"),
                                             bn_fold=fold)
    paths["poly"] = export_predict(tr, state, 0, str(root / "poly.plx"), bn_fold=True)
    imgs = np.random.default_rng(7).uniform(size=(5, S, S, 3)).astype(np.float32)
    return dict(dt=dt, jtr=jtr, jstate=jstate, tr=tr, state=state, imgs=imgs, paths=paths,
                root=root)


@pytest.mark.parametrize("bn_fold", [True, False])
def test_artifact_matches_the_jax_artifact(pair, bn_fold):
    tr, state, imgs = pair["tr"], pair["state"], pair["imgs"][:2]
    jcall, jmeta = j_load_exported(pair["paths"]["jax", bn_fold])
    call, meta = load_exported(pair["paths"]["port", bn_fold], "cpu")
    want = np.asarray(jcall(imgs), np.float32)
    got = call(imgs).numpy()
    assert got.shape == want.shape == (2, S, S) and got.dtype == np.float32
    assert _rel(got, want) <= TOL[pair["dt"]]
    assert set(meta) == set(jmeta)
    assert {k: v for k, v in meta.items() if k != "platforms"} == {
        k: v for k, v in jmeta.items() if k != "platforms"}
    assert meta["platforms"] == ["cuda", "cpu"] and jmeta["platforms"] == ["cpu"]
    # the artifact is the graph of predict / predict_bnfold, which it equals
    ref = (tr.predict_bnfold if bn_fold else tr.predict)(state, imgs).numpy()
    assert _rel(got, ref) <= 1e-6


def test_polymorphic_artifact_serves_any_batch(pair):
    tr, state, imgs = pair["tr"], pair["state"], pair["imgs"]
    call, meta = load_exported(pair["paths"]["poly"], "cpu")
    assert meta["batch_size"] is None
    ref = tr.predict_bnfold(state, imgs).numpy()
    for n in (1, 3, 5):
        out = call(imgs[:n]).numpy()
        assert out.shape == (n, S, S) and np.isfinite(out).all()
        assert _rel(out, ref[:n]) <= 1e-6


def test_fixed_batch_artifact_refuses_another_batch(pair):
    call, meta = load_exported(pair["paths"]["port", True], "cpu")
    assert meta["batch_size"] == 2
    assert call(pair["imgs"][:2]).shape == (2, S, S)
    with pytest.raises(Exception, match="shape|size|Guard"):
        call(pair["imgs"][:3])


def test_artifact_loads_without_model_code(pair):
    """A fresh process loads and runs the artifact importing only
    serve/export.py (torch, json, numpy): no module of the models."""
    root, path = pair["root"], pair["paths"]["poly"]
    x, y = str(root / "x.npy"), str(root / "y.npy")
    np.save(x, pair["imgs"][:3])
    code = (
        "import sys, numpy as np\n"
        "from pldepth_torch.serve.export import load_exported\n"
        f"call, meta = load_exported({path!r}, 'cpu')\n"
        f"np.save({y!r}, call(np.load({x!r})).numpy())\n"
        "print(sorted(m for m in sys.modules if m.startswith('pldepth')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    mods = eval(r.stdout.strip().splitlines()[-1])
    assert mods == ["pldepth_torch", "pldepth_torch.serve", "pldepth_torch.serve.export"]
    call, _ = load_exported(path, "cpu")
    np.testing.assert_array_equal(np.load(y), call(pair["imgs"][:3]).numpy())


def test_jax_artifact_platforms_and_devices_are_checked(pair):
    tr, state, root = pair["tr"], pair["state"], pair["root"]
    with pytest.raises(ValueError, match="JAX"):
        load_exported(pair["paths"]["jax", True], "cpu")
    with pytest.raises(ValueError, match="unknown platform"):
        export_predict(tr, state, 2, str(root / "x.plx"), platforms=("tpu", "cpu"))
    with pytest.raises(ValueError, match="exported for"):
        j_meta_path = str(root / "cpu_only.plx")
        with open(pair["paths"]["port", True], "rb") as f:
            blob = f.read()
        n = 15 + 4 + int.from_bytes(blob[15:19], "little")
        meta = json.loads(blob[19:n])
        meta_b = json.dumps({**meta, "platforms": ["cpu"]}).encode()
        with open(j_meta_path, "wb") as f:
            f.write(blob[:15] + len(meta_b).to_bytes(4, "little") + meta_b + blob[n:])
        load_exported(j_meta_path, "cuda")
    infer, meta = artifact_infer(pair["paths"]["port", True], "cpu")
    out = infer(pair["imgs"][:2])
    assert isinstance(out, np.ndarray) and out.shape == (2, S, S)


def _put_images(d, names):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(len(names))
    for n in names:
        Image.fromarray(rng.integers(0, 256, (S, S + 8, 3), np.uint8)).save(os.path.join(d, n))


def _port_cli(*argv):
    from pldepth_torch.cli import main

    assert main(list(argv) + ["--device", "cpu"]) == 0


@pytest.fixture(scope="module")
def cli_weights(tmp_path_factory):
    from pldepth_torch.train.checkpoint import save_weights_npz

    root = tmp_path_factory.mktemp("export_cli")
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=S), device="cpu")
    wpath = str(root / "w.npz")
    save_weights_npz(wpath, tr.init_state())
    _put_images(str(root / "in"), [f"im{i}.png" for i in range(5)])
    return root, wpath


@pytest.mark.parametrize("batch", [2, 0])
def test_cli_export_then_serve_artifact_equals_serving_the_weights(cli_weights, batch, capsys):
    """5 images: a fixed-batch 2 artifact pads its tail chunk, a
    polymorphic one serves chunks of --batch_size 2 unpadded; both write
    the maps of the weights' bn_fold graph (bf16, the CLI's default)."""
    root, wpath = cli_weights
    out, watch = str(root / f"m{batch}.plx"), str(root / "in")
    _port_cli("export", "--model_name", "ff_smoke", "--input_size", str(S),
              "--batch_size", str(batch), "--load_model_path", wpath, "--out", out)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"out": out, "platforms": "cuda,cpu", "batch_size": batch, "input_size": S}
    a, b = str(root / f"a{batch}"), str(root / f"b{batch}")
    # --input_size is ignored under --artifact: the metadata's is used
    _port_cli("serve", "--artifact", out, "--watch_dir", watch, "--out_dir", a,
              "--once", "true", "--poll_interval", "0.01", "--batch_size", "2",
              "--input_size", "448")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "processed": 5, "out_dir": a}
    _port_cli("serve", "--model_name", "ff_smoke", "--input_size", str(S), "--batch_size", "2",
              "--load_model_path", wpath, "--quantize", "", "--watch_dir", watch,
              "--out_dir", b, "--once", "true", "--poll_interval", "0.01")
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) == [f"im{i}_depth.npy" for i in range(5)]
    for n in names:
        got, want = np.load(os.path.join(a, n)), np.load(os.path.join(b, n))
        assert got.shape == (S, S) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, want, err_msg=n)
