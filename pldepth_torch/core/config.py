"""Experiment configuration, field for field the JAX package's
``pldepth_tpu/core/config.py``, so one ``configs/*.json`` file loads
unchanged in both packages.

The port keeps every field, including those whose feature it does not
implement yet (samplers, training options, the mesh): a config written for
the JAX package must round-trip here without loss. Fields the port ignores
are listed in ROADMAP.md queue 1.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. The port serves on one device; the layout is kept
    so configs round-trip and multi-GPU data parallelism has its knobs."""

    data: int = -1  # -1 => use all available devices
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")

    def resolved_data(self, n_devices: int) -> int:
        if self.data == -1:
            if n_devices % self.model:
                raise ValueError(
                    f"device count {n_devices} not divisible by model={self.model}"
                )
            return n_devices // self.model
        return self.data


@dataclass(frozen=True)
class ExperimentConfig:
    # --- reference CLI surface ---
    model_name: str = "ff_effnet"
    epochs: int = 50
    batch_size: int = 4
    seed: int = 0
    ranking_size: int = 3
    rankings_per_image: int = 100
    initial_lr: float = 0.01
    equality_threshold: float = 0.03
    model_checkpoints: bool = False
    load_model_path: str = ""
    augmentation: bool = True
    warmup: int = 0
    sampling_type: int = 1
    lr_multi: float = 0.25
    ds_size: Optional[int] = None

    # --- data ---
    dataset: str = "HR-WSI"
    data_root: str = ""
    input_size: int = 224
    val_rankings_per_img: Optional[int] = None
    val_split_denom: int = 15
    oversample_factor: Optional[float] = None
    sampler_draw_method: str = "auto"
    prefetch_depth: int = 2
    uint8_wire: bool = False
    data_resident: bool = False
    resident_chain_steps: int = 1

    # --- schedule / optimizer ---
    schedule: str = "sgdr"
    lr_decay: float = 0.9
    sgdr_mult_factor: float = 1.0
    sgdr_cycle_epochs: Optional[int] = None
    step_milestones: Tuple[int, ...] = (80, 120, 160, 180)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-7
    grad_accum: int = 1

    # --- model ---
    freeze_encoder: bool = True
    pretrained_path: str = ""
    compute_dtype: str = "bfloat16"  # params stay float32, cast at use
    remat_encoder: bool = False
    sparse_tail: bool = False
    qres: str = ""
    qenc: str = ""
    fused_tail: bool = True
    decoder_head_ch: int = 32

    # --- loss ---
    listmle_impl: str = "auto"

    # --- parallelism ---
    mesh: MeshConfig = field(default_factory=MeshConfig)
    spatial_sharding: bool = False

    # --- observability / io ---
    output_dir: str = "runs"
    log_every: int = 0
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 3
    use_wandb: bool = False
    use_tensorboard: bool = False
    use_mlflow: bool = False
    mlflow_tracking_uri: str = ""
    profile: bool = False
    parity_report: bool = False
    parity_target_whdr: float = -1.0
    parity_budget: float = 0.005

    # ------------------------------------------------------------------
    @property
    def val_rpi(self) -> int:
        return (
            self.val_rankings_per_img
            if self.val_rankings_per_img is not None
            else self.rankings_per_image
        )

    @property
    def input_shape(self) -> Tuple[int, int, int]:
        return (self.input_size, self.input_size, 3)

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    # -- (de)serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ExperimentConfig":
        # underscore-prefixed keys are comments ("_comment" in configs/*.json)
        d = {k: v for k, v in d.items() if not k.startswith("_")}
        mesh = d.pop("mesh", None)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        cfg = cls(**d)
        if mesh is not None:
            if isinstance(mesh, Mapping):
                mesh_d = dict(mesh)
                if "axis_names" in mesh_d:
                    mesh_d["axis_names"] = tuple(mesh_d["axis_names"])
                mesh = MeshConfig(**mesh_d)
            cfg = cfg.replace(mesh=mesh)
        if isinstance(cfg.step_milestones, list):
            cfg = cfg.replace(step_milestones=tuple(cfg.step_milestones))
        return cfg

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(s))


SAMPLING_TYPE_NAMES = {
    0: "thresholded",
    1: "info_score",
    2: "masked",
    3: "purely_masked",
    4: "segment",
}


def sampler_name_for_type(sampling_type: int) -> str:
    if sampling_type not in SAMPLING_TYPE_NAMES:
        raise ValueError(
            f"wrong selection of sampling type: {sampling_type} "
            f"(valid: {sorted(SAMPLING_TYPE_NAMES)})"
        )
    return SAMPLING_TYPE_NAMES[sampling_type]
