"""Port ff_effnet (B0) in f32 against the TF-reference golden
(tests/golden/full_model_ff_effnet.npz, made by tools/full_parity_check.py
from the reference's own Keras graph). Weights come from the golden's names
through the port's copy of ``synth_weight``: no JAX, no weight archive.
``predict`` at rel < 5e-5 (the bound of tests/test_full_parity.py);
``predict_fused`` (the plain K2 version on the CPU) at rel < 2e-4."""

import os

import numpy as np
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.models import get_pl_depth_net
from pldepth_torch.models.pretrained import overlay_synthetic
from pldepth_torch.train import Trainer

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "full_model_ff_effnet.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _trainer_and_state(golden, fused_tail=True):
    cfg = ExperimentConfig(model_name="ff_effnet", input_size=96,
                           compute_dtype="float32", fused_tail=fused_tail)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    overlay_synthetic(state.model, golden["names"])
    return trainer, state


@pytest.mark.parametrize("fused_tail", [True, False])
def test_predict_matches_tf_golden(golden, fused_tail):
    trainer, state = _trainer_and_state(golden, fused_tail)
    pred = trainer.predict(state, golden["x_raw"] / 255.0).numpy()
    assert pred.shape == (2, 96, 96)
    rel = _rel(pred, golden["ref_infer"][..., 0])
    assert rel < 5e-5, f"inference forward diverges from TF: rel {rel:.2e}"


def test_predict_fused_matches_tf_golden(golden):
    trainer, state = _trainer_and_state(golden)
    pred = trainer.predict_fused(state, golden["x_raw"] / 255.0).numpy()
    rel = _rel(pred, golden["ref_infer"][..., 0])
    assert rel < 2e-4, f"fused serving forward diverges from TF: rel {rel:.2e}"


def test_golden_names_cover_the_port_model(golden):
    """Every tensor of the port's ff_effnet is named in the golden, so the
    parity above leaves no tensor at its random init."""
    from pldepth_torch.models.pretrained import flax_key_to_torch

    module = get_pl_depth_net("ff_effnet", "float32").make()
    names = {flax_key_to_torch(str(n)) for n in golden["names"]}
    assert names == set(module.state_dict())
