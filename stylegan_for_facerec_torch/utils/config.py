"""The stages' configurations, as
``stylegan_for_facerec_tpu/utils/config.py``'s ``Stage1Config``,
``Stage2Options``, ``Stage2TestOptions`` and ``Stage3Options``: loaded
from JSON or YAML (``load_config``, e.g.
``configs/stage1_stylegan2_ada.json``), and stage 3's converted from a
reference python config's ``configurations`` dict
(``from_reference_stage3``). The stage-2 records hold the JAX package's
fields and defaults; the stage-2 CLIs keep their own argparse defaults,
as the JAX CLIs do.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Sequence, Tuple


@dataclasses.dataclass
class Stage1Config:
    """StyleGAN2-ADA GAN pretraining (``configs/stage1_stylegan2_ada.json``),
    plus the port's ``compute_dtype``: "float32", or "bfloat16" for bf16
    compute with float32 parameters and optimizer state."""

    image_size: int = 128
    z_dim: int = 512
    w_dim: int = 512
    num_mapping_layers: int = 8
    batch_size: int = 8
    lr_g: float = 0.002
    lr_d: float = 0.00235
    lambda_gp: float = 4.0          # R1 gamma
    lambda_plp: float = 2.0         # path-length penalty weight
    lazy_gradient_penalty_interval: int = 16
    lazy_path_penalty_after: int = 0
    lazy_path_penalty_interval: int = 4
    ada_start_p: float = 0.0
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_fixed: bool = False
    ema_beta: float = 0.999
    num_epochs: int = 500
    batches_per_epoch: int = 4000
    compute_dtype: str = "float32"


@dataclasses.dataclass
class Stage2Options:
    """ReStyle pSp training (the reference's ``options/train_options.py``
    and its README's stage-2 recipe)."""

    dataset_type: str = "afr_asian_faces"
    encoder_type: str = "BackboneEncoder"
    output_size: int = 128
    input_nc: int = 6
    n_iters_per_batch: int = 1
    batch_size: int = 8
    workers: int = 32
    learning_rate: float = 1e-4
    optim_name: str = "ranger"
    train_decoder: bool = False
    lpips_lambda: float = 0.8
    l2_lambda: float = 1.0
    id_lambda: float = 0.0
    w_norm_lambda: float = 0.0
    moco_lambda: float = 0.0
    max_steps: int = 2_500_000
    val_interval: int = 1000
    save_interval: int = 1000
    image_interval: int = 100
    board_interval: int = 50
    stylegan_weights: Optional[str] = None
    checkpoint_path: Optional[str] = None


@dataclasses.dataclass
class Stage2TestOptions:
    """Inference options (the reference's ``options/test_options.py``),
    with the encoder-bootstrapping model pair."""

    exp_dir: str = "./inference"
    checkpoint_path: Optional[str] = None
    data_path: Optional[str] = None
    resize_outputs: bool = True
    test_batch_size: int = 8
    n_iters_per_batch: int = 5
    model_1_checkpoint_path: Optional[str] = None
    model_2_checkpoint_path: Optional[str] = None


@dataclasses.dataclass
class Stage3Options:
    """Face-recognition training, the fields of the reference's
    ``configurations`` dict."""

    name: str = "BUPT_IR_50"
    data_root: str = "./data"
    train_subdir: str = "bupt-balancedface/race_per_7000_aligned_112"
    model_root: str = "./checkpoints"
    backbone: str = "pSp"            # 'pSp' | IR_50 ... | MobileFaceNet
    head: str = "ArcFace"
    loss: str = "Focal"
    encoder_checkpoint: Optional[str] = None
    avg_image: Optional[str] = None
    input_size: Tuple[int, int] = (112, 112)
    emb_size: int = 512
    batch_size: int = 100
    lr: float = 0.03
    momentum: float = 0.9
    weight_decay: float = 2e-3
    num_epochs: int = 100
    stages: Sequence[int] = tuple(range(15, 130, 5))
    warmup_epochs: int = 0
    freeze_backbone_epochs: int = 3
    dropout: float = 0.15
    arcface_s: float = 64.0
    margin: float = 0.5
    rgb_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    rgb_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    num_workers: int = 8
    drop_last: bool = True
    start_epoch: int = 0
    backbone_resume: Optional[str] = None
    head_resume: Optional[str] = None
    optimizer_resume: Optional[str] = None
    eval_benchmarks: Sequence[str] = ("rfw_African", "rfw_Asian",
                                      "rfw_Caucasian", "rfw_Indian")


def _from_dict(cls, d: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in fields})


def load_config(cls, path: str):
    """Load a dataclass config from .json or .yaml/.yml; keys that are not
    fields of ``cls`` are ignored."""
    if path.endswith((".yaml", ".yml")):
        import yaml
        with open(path) as f:
            return _from_dict(cls, yaml.safe_load(f))
    with open(path) as f:
        return _from_dict(cls, json.load(f))


def from_reference_stage3(configurations: Dict[int, Dict[str, Any]],
                          index: int = 1) -> Stage3Options:
    """Convert a reference ``configurations`` dict (the python-module
    config format) into Stage3Options."""
    c = configurations[index]
    return Stage3Options(
        name=c.get("NAME", "stage3"),
        data_root=c.get("DATA_ROOT", "./data"),
        model_root=c.get("MODEL_ROOT", "./checkpoints"),
        backbone=c.get("BACKBONE_NAME", "pSp"),
        head=c.get("HEAD_NAME", "ArcFace"),
        loss=c.get("LOSS_NAME", "Focal"),
        encoder_checkpoint=c.get("ENCODER_CHECKPOINT"),
        avg_image=c.get("ENCODER_AVG_IMAGE"),
        input_size=tuple(c.get("INPUT_SIZE", (112, 112))),
        emb_size=c.get("EMBEDDING_SIZE", 512),
        # joined with DATA_ROOT as it is
        train_subdir=c.get("TRAIN_IMAGES_FOLDER",
                           Stage3Options.train_subdir),
        drop_last=c.get("DROP_LAST", True),
        num_workers=c.get("NUM_WORKERS", 8),
        batch_size=c.get("BATCH_SIZE", 100),
        lr=c.get("LR", 0.03),
        momentum=c.get("MOMENTUM", 0.9),
        weight_decay=c.get("WEIGHT_DECAY", 2e-3),
        num_epochs=c.get("NUM_EPOCH", 100),
        stages=tuple(c.get("STAGES", ())),
        # WARMUP defaults to True; warmup spans NUM_EPOCH // 25 epochs
        warmup_epochs=(c.get("NUM_EPOCH", 100) // 25
                       if c.get("WARMUP", True) else 0),
        freeze_backbone_epochs=c.get("FREEZE_BACKBONE_EPOCHS", 0),
        dropout=c.get("ENCODER_ADDITIONAL_DROPOUT", 0.0) or 0.0,
        arcface_s=c.get("ARCFACE_S", 64.0),
        start_epoch=c.get("START_EPOCH", 0),
        backbone_resume=c.get("BACKBONE_RESUME_ROOT") or None,
        head_resume=c.get("HEAD_RESUME_ROOT") or None,
        optimizer_resume=c.get("OPTIMIZER_RESUME_ROOT") or None,
    )
