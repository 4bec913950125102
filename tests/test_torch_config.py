"""The port's ExperimentConfig/MeshConfig against the JAX package's: same
fields and defaults, and every checked-in configs/*.json loads to equal
values in both packages."""

import dataclasses
import glob
import json
import os

import pytest
import torch

from pldepth_torch.core import config as tcfg
from pldepth_torch.core.device import resolve_device, torch_dtype
from pldepth_torch.core.rng import derive_seed, generator
from pldepth_tpu.core import config as jcfg

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.json")))


@pytest.mark.parametrize("cls", ["ExperimentConfig", "MeshConfig"])
def test_fields_and_defaults_match(cls):
    t, j = getattr(tcfg, cls), getattr(jcfg, cls)
    tf = {f.name: f for f in dataclasses.fields(t)}
    jf = {f.name: f for f in dataclasses.fields(j)}
    assert list(tf) == list(jf)
    assert tcfg.SAMPLING_TYPE_NAMES == jcfg.SAMPLING_TYPE_NAMES
    if cls == "ExperimentConfig":
        td, jd = t().to_dict(), j().to_dict()
    else:
        td, jd = dataclasses.asdict(t()), dataclasses.asdict(j())
    assert td == jd


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_checked_in_configs_load_equal(path):
    with open(path) as f:
        raw = json.load(f)
    t = tcfg.ExperimentConfig.from_dict(raw)
    j = jcfg.ExperimentConfig.from_dict(raw)
    assert t.to_dict() == j.to_dict()
    assert tcfg.ExperimentConfig.from_json(t.to_json()) == t
    assert t.mesh.resolved_data(8) == j.mesh.resolved_data(8)


def test_unknown_key_raises():
    with pytest.raises(ValueError, match="Unknown config keys"):
        tcfg.ExperimentConfig.from_dict({"no_such_field": 1})


def test_device_and_rng():
    assert resolve_device("cpu").type == "cpu"
    assert torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        torch_dtype("float7")
    a = torch.rand(4, generator=generator(3, "init"))
    b = torch.rand(4, generator=generator(3, "init"))
    c = torch.rand(4, generator=generator(3, "init", 1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert derive_seed(0, "x") != derive_seed(0, "y")
