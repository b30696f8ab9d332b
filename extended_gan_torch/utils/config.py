"""Experiment configuration.

The port's own copy of ``extended_gan_tpu/utils/config.py``: it reads the
same experiment ``config.py`` files (a directory with a ``config.py`` of
UPPER_CASE literals), parsed declaratively with ``ast.literal_eval`` and
validated into :class:`ExperimentConfig`. The fields are the JAX package's,
so one experiment directory drives both packages; fields the port does not
act on yet (mesh axes, megastep, ...) are parsed and ignored.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class ExperimentConfig:
    """Everything convolutional_gat's train() accepts, plus the JAX
    package's hardware knobs (kept so its config files parse unchanged)."""

    model_type: str = "temporal"
    mapping_type: str = "linear"
    dataset: str = "kmni"
    preprocessed_folder: str = ""
    output_path: str = ""
    epochs: int = 10
    train_batch_size: int = 32
    test_batch_size: int = 64
    learning_rate: float = 1e-3
    lr_step: int = 1
    gamma: float = 0.95
    plot: bool = False
    criterion: str = "mse"
    optimizer: str = "adam"
    weight_decay: float = 0.01
    downsample_size: tuple[int, int] = (256, 256)
    test_first: bool = False
    reduce_lr_on_plateau: bool = False
    # --- the JAX package's additions (absent from the reference) ---------
    precision: str = "f32"  # "f32" | "bf16"
    data_axis: int | None = None
    model_axis: int = 1
    seed: int = 369
    resume: bool = False
    checkpoint_every: int = 0
    remat: bool = False
    shuffle_mode: str = "batch"
    megastep: int = 0
    spatial: bool = False
    fsdp: bool = False
    fsdp_min_size: int = 4096
    moe_experts: int = 0
    moe_aux_weight: float = 0.01
    pipeline_stages: int = 0
    pp_microbatches: int = 0
    resident: bool = False
    # fused kernels; None = auto (on when the model sits on the CUDA card)
    use_pallas: bool | None = None

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


_TUPLE_FIELDS = {"downsample_size"}


def _literal_env(path: str) -> dict[str, Any]:
    """Evaluate UPPER_CASE assignments in a config.py as literals only.

    No code runs: only ``NAME = <literal>`` assignments are honoured.
    Non-literal values (e.g. ``OPTIMIZER = torch.optim.Adam`` in legacy
    configs) keep the (dotted) name's last part; anything else is skipped
    with a warning.
    """
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out: dict[str, Any] = {}
    for node in tree.body:
        # NAME = <literal> and the annotated form NAME: int = <literal>
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target, value = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            target, value = node.target, node.value
        else:
            continue
        if isinstance(target, ast.Name) and target.id.isupper():
            try:
                out[target.id] = ast.literal_eval(value)
            except ValueError:
                if isinstance(value, ast.Name):
                    out[target.id] = value.id
                elif isinstance(value, ast.Attribute):
                    out[target.id] = value.attr.lower()
                elif isinstance(value, ast.Call):
                    fn = value.func
                    name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
                    out[target.id] = name.replace("Loss", "").lower()
                else:
                    print(f"[config] could not parse {target.id} in "
                          f"{path}; using the default")
    return out


# Legacy ``MODEL = <class>`` configs predate MODEL_TYPE: map the class name
# onto the registry key for the same architecture.
_LEGACY_MODEL_CLASSES = {
    "baselinemodel": "baseline",
    "baselinemodel2d": "baseline2d",
    "temporalmodel": "temporal_1block",
    "spatialmodel": "spatial_1block",
    "multistreammodel": "multi_stream_2block",
    "unetmodel": "unet",
    "model": "temporal",  # GAT3D.GATMultistream.Model (attention via type)
}


def load_experiment_config(exp_dir: str) -> ExperimentConfig:
    """Load ``<exp_dir>/config.py`` into an ExperimentConfig."""
    variables = _literal_env(os.path.join(exp_dir, "config.py"))
    kwargs = {k.lower(): v for k, v in variables.items()}
    known = {f.name for f in dataclasses.fields(ExperimentConfig)}
    legacy_model = kwargs.pop("model", None)
    if legacy_model is not None and "model_type" not in kwargs:
        mapped = _LEGACY_MODEL_CLASSES.get(str(legacy_model).lower())
        if mapped is None:
            print(f"[config] unknown legacy MODEL {legacy_model!r}; "
                  f"using the model_type default")
        else:
            kwargs["model_type"] = mapped
    for name_field in ("optimizer", "criterion"):
        if isinstance(kwargs.get(name_field), str):
            kwargs[name_field] = kwargs[name_field].lower()
    extra = {k: v for k, v in kwargs.items() if k not in known}
    kwargs = {k: v for k, v in kwargs.items() if k in known}
    for f in _TUPLE_FIELDS:
        if f in kwargs and isinstance(kwargs[f], list):
            kwargs[f] = tuple(kwargs[f])
    cfg = ExperimentConfig(**kwargs)
    cfg.output_path = exp_dir
    if extra:
        print(f"[config] ignoring unknown keys: {sorted(extra)}")
    return cfg


def dump_config(cfg: ExperimentConfig):
    """Print the settings a run uses, as UPPER_CASE config keys."""
    print(json.dumps({k.upper(): v for k, v in cfg.to_dict().items()},
                     indent=4, default=str))
