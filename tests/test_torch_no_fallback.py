"""The port stands alone and never swaps devices: no module of
``pldepth_torch`` (nor ``chip_smoke.py``) imports jax, flax or
pldepth_tpu, and none imports cv2, PIL, scipy, h5py, TensorFlow,
matplotlib, wandb, mlflow or TensorBoard when it is imported (the readers,
scenes, the sinks, the plots and the converter import them where they use
them); entry points and the resident store raise without a card unless
the CPU is asked for; the kernel wrappers and the packed reader's build
have no try/except path; chip_smoke.py fails without a card and when run away from the repository."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pldepth_tpu"}
SOURCES = sorted(glob.glob(os.path.join(REPO, "pldepth_torch", "**", "*.py"), recursive=True)) + [
    os.path.join(REPO, "chip_smoke.py")]


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


LAZY = {"cv2", "PIL", "scipy", "h5py", "tensorflow", "matplotlib", "wandb", "mlflow",
        "tensorboard"}


def _import_time_imports(path):
    """Modules imported when ``path`` is imported: its body, outside any
    function or class."""
    stack = list(ast.parse(open(path).read(), filename=path).body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, REPO))
def test_optional_libraries_are_imported_lazily(path):
    bad = [m for m in _import_time_imports(path) if m.split(".")[0] in LAZY]
    assert not bad, f"{path} imports {bad} when it is imported"


def test_data_path_imports_no_optional_library():
    """Importing the data path (scenes, the packed reader, the resident
    store, the trainer) loads neither cv2 nor scipy: scenes imports them
    inside the functions that use them."""
    code = ("import sys; import pldepth_torch.data, pldepth_torch.data.scenes, "
            "pldepth_torch.data.packed, pldepth_torch.data.resident, pldepth_torch.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'cv2', 'scipy', 'PIL', 'h5py'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_new_slice_imports_no_optional_library():
    """Importing active learning, the small commands' modules and the quant
    gate loads neither cv2 nor PIL: they import them where they use them."""
    code = ("import sys; import pldepth_torch.active, pldepth_torch.diagnostics.chi2, "
            "pldepth_torch.data.offline, pldepth_torch.data.ordinal, "
            "pldepth_torch.data.partial, pldepth_torch.tools.quant_metric_gate, "
            "pldepth_torch.cli; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'cv2', 'scipy', 'PIL', 'h5py'}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_sweeps_logging_and_convert_import_no_optional_library():
    """Importing the sweeps, the analysis, the loggers and profiling, the
    Keras converter and the CLI loads none of TensorFlow, matplotlib,
    wandb, mlflow or TensorBoard: each is imported where it is used."""
    code = ("import sys; import pldepth_torch.sweep, pldepth_torch.sweep.analyze, "
            "pldepth_torch.obs, pldepth_torch.models.convert, pldepth_torch.cli; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'tensorflow', 'keras', "
            "'matplotlib', 'wandb', 'mlflow', 'tensorboard'}), "
            "'torch.utils.tensorboard' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[] False"


@pytest.mark.parametrize("command", ["sweep", "warmup"])
def test_cli_sweep_warmup_raise_without_a_card(monkeypatch, tmp_path, command):
    """No --device: the card is asked for, and its absence raises before
    a state file, a run directory or a kernel library is written."""
    from pldepth_torch.cli import main
    from pldepth_torch.data import packed
    from pldepth_torch.ops import _build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(packed, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, "--model_name", "ff_smoke", "--input_size", "32", "--ds_size", "16",
              "--output_dir", str(tmp_path / "out")])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("command", ["active", "dump", "chi2"])
def test_cli_active_dump_chi2_raise_without_a_card(monkeypatch, tmp_path, command):
    from pldepth_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = ["--out_dir", str(tmp_path / "d")] if command == "dump" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([command, "--model_name", "ff_smoke", "--dataset", "scenes", "--input_size", "32",
              "--ds_size", "16", "--output_dir", str(tmp_path), *extra])
    assert os.listdir(tmp_path) == []  # nothing written before the check


def test_entry_points_raise_without_a_card(monkeypatch):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.core.device import resolve_device
    from pldepth_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ExperimentConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert Trainer(ExperimentConfig(model_name="ff_smoke"), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module,fn", [
    ("fused_mbconv.py", "fused_mbconv_infer"),
    ("banded_mbconv.py", "banded_mbconv_infer"),
    ("listmle_kernel.py", "listmle_fwd"),
    ("listmle_kernel.py", "listmle_bwd"),
    ("listmle_kernel.py", "_launch"),
    ("listmle_kernel.py", "ListMLESorted"),
    ("listmle_kernel.py", "ranking_loss_fwd"),
    ("listmle_kernel.py", "ranking_loss_bwd"),
    ("listmle_kernel.py", "RankingLoss"),
    ("../data/packed.py", "build_native"),
    ("../data/packed.py", "_load_lib"),
    ("../data/packed.py", "NativePackedIterator"),
    ("qres.py", "BnActTrain"),
    ("qres.py", "MulQ8"),
    ("sparse_tail.py", "sparse_upsample2x_taps"),
    ("../models/pldepth_net.py", "remat_encoder"),
    ("../serve/export.py", "export_predict"),
    ("../serve/export.py", "load_exported"),
    ("../serve/daemon.py", "artifact_infer"),
])
def test_kernel_wrapper_has_no_fallback_path(module, fn):
    path = os.path.join(REPO, "pldepth_torch", "ops", module)
    tree = ast.parse(open(path).read())
    node = next(n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == fn)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(node))


def test_auto_impl_sends_cuda_tensors_to_the_kernel(monkeypatch):
    """listmle_nll with impl="auto" on a CUDA tensor takes the K1 autograd
    Function (whose wrappers launch or raise), never the plain loss."""
    from pldepth_torch.core.device import resolve_impl
    from pldepth_torch.ops import listmle

    assert resolve_impl("auto", torch.device("cuda")) == "pallas"
    seen = []
    monkeypatch.setattr(listmle, "resolve_impl", lambda impl, dev: "pallas")
    monkeypatch.setattr(listmle, "listmle_sorted", lambda s: seen.append("kernel") or s.sum(-1))
    monkeypatch.setattr(listmle, "listmle_sorted_plain",
                        lambda s: (_ for _ in ()).throw(AssertionError("plain")))
    listmle.listmle_nll(torch.zeros(3, 4), torch.zeros(3, 4), impl="auto")
    assert seen == ["kernel"]


def test_auto_impl_sends_cuda_maps_to_the_fused_kernel(monkeypatch):
    """pl_ranking_loss with impl="auto" on a CUDA map takes the fused K1
    Function (whose wrappers launch or raise), never the plain loss."""
    from pldepth_torch.ops import listmle

    seen = []
    monkeypatch.setattr(listmle, "resolve_impl", lambda impl, dev: "pallas")
    monkeypatch.setattr(listmle, "ranking_loss", lambda p, r: seen.append("kernel") or p.sum())
    monkeypatch.setattr(listmle, "ranking_loss_plain",
                        lambda p, r: (_ for _ in ()).throw(AssertionError("plain")))
    listmle.pl_ranking_loss(torch.zeros(1, 4, 4, 1), torch.zeros(1, 2, 3, 2), impl="auto")
    assert seen == ["kernel"]


def test_resident_store_raises_without_a_card(monkeypatch):
    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.data.resident import build_resident_store

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = SyntheticDepthDataset(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_resident_store(ds)
    assert build_resident_store(ds, "cpu").arrays["image"].device.type == "cpu"


def test_trainer_and_cli_train_raise_without_a_card(monkeypatch, tmp_path):
    from pldepth_torch.cli import main
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(ExperimentConfig(model_name="ff_smoke"), steps_per_epoch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", "--model_name", "ff_smoke", "--output_dir", str(tmp_path)])


def test_failed_build_raises_with_nvcc_output(monkeypatch, tmp_path):
    from pldepth_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'listmle.cu(1): error: no such thing'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no such thing"):
        _build.build(["listmle"])


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_export_module_imports_no_model_code():
    """serve/export.py loads artifacts with torch, json and numpy alone: at
    import it pulls in nothing of pldepth_torch (the model code comes in
    only inside export_predict)."""
    path = os.path.join(REPO, "pldepth_torch", "serve", "export.py")
    mods = {m.split(".")[0] for m in _import_time_imports(path)}
    assert mods <= {"__future__", "io", "json", "logging", "os", "typing", "numpy", "torch"}, mods
    code = ("import sys; import pldepth_torch.serve.export; "
            "print(sorted(m for m in sys.modules if m.startswith('pldepth_torch')))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(["pldepth_torch", "pldepth_torch.serve",
                                    "pldepth_torch.serve.export"])


def test_artifact_loading_and_qenc_raise_without_a_card(monkeypatch, tmp_path):
    """An artifact loads on the card unless the CPU is asked for, and a
    qenc int8 step never swaps its missing int8 graph for the float one."""
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.serve.export import export_predict, load_exported
    from pldepth_torch.train import Trainer

    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=32), device="cpu")
    state = tr.init_state()
    path = str(tmp_path / "m.plx")
    export_predict(tr, state, 1, path, bn_fold=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(path)
    assert load_exported(path, "cpu")[1]["batch_size"] == 1
    qtr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=32, qenc="int8",
                                   freeze_encoder=True), device="cpu")
    with pytest.raises(RuntimeError, match="prepare_qenc"):
        qtr._qenc_encoder(qtr.init_state().model)
