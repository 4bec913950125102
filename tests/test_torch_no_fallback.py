"""The port stands alone and never swaps devices: no module of
``pldepth_torch`` (nor ``chip_smoke.py``) imports jax, flax or
pldepth_tpu; entry points raise without a card unless the CPU is asked
for; the K2 wrapper has no try/except path; chip_smoke.py fails without a
card and when run away from the repository."""

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
