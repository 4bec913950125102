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


def test_kernel_wrapper_has_no_fallback_path():
    path = os.path.join(REPO, "pldepth_torch", "ops", "fused_mbconv.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "fused_mbconv_infer")
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))


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
