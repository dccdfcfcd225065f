"""Stage-2 dataset, transform and path registries, as
``stylegan_for_facerec_tpu/data/registry.py``: the restyle-encoder's
``data_configs``, ``transforms_config`` (ground truth, test and inference
images resized to 112², the source kept as it is, all in [-1, 1]) and
``paths_config``. ``DATASET_PATHS`` is for the user to fill; the
``mtcnn_*`` entries of ``MODEL_PATHS`` name the detector weights that ship
with this package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

DATASET_PATHS: Dict[str, str] = {
    "ffhq": "",
    "celeba_test": "",
    "celeba_test_112p": "",
    "cars_train": "", "cars_test": "",
    "church_train": "", "church_test": "",
    "horse_train": "", "horse_test": "",
    "afhq_wild_train": "", "afhq_wild_test": "",
    "AfrAsianFaceSet": "",
}

MTCNN_WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "mtcnn_weights")

MODEL_PATHS: Dict[str, str] = {
    "ir_se50": "pretrained_models/model_ir_se50.pth",
    "stylegan_ffhq": "pretrained_models/stylegan2-ffhq-config-f.pt",
    "mtcnn_pnet": os.path.join(MTCNN_WEIGHTS_DIR, "pnet.npy"),
    "mtcnn_rnet": os.path.join(MTCNN_WEIGHTS_DIR, "rnet.npy"),
    "mtcnn_onet": os.path.join(MTCNN_WEIGHTS_DIR, "onet.npy"),
    "moco": "pretrained_models/moco_v2_800ep_pretrain.pth.tar",
}


@dataclasses.dataclass(frozen=True)
class TransformSpec:
    """Side lengths of each role's images (None: kept as they are); every
    image is mapped to [-1, 1]."""

    source_size: Optional[int] = None
    gt_size: Optional[int] = 112
    test_size: Optional[int] = 112
    inference_size: Optional[int] = 112


ENCODE_TRANSFORMS = TransformSpec()
CARS_TRANSFORMS = TransformSpec(gt_size=192, test_size=192,
                                inference_size=192)

DATASETS: Dict[str, dict] = {
    name: {
        "transforms": CARS_TRANSFORMS if name == "cars_encode"
        else ENCODE_TRANSFORMS,
        "train_source_root": DATASET_PATHS.get(src, ""),
        "train_target_root": DATASET_PATHS.get(src, ""),
        "test_source_root": DATASET_PATHS.get(test, ""),
        "test_target_root": DATASET_PATHS.get(test, ""),
    }
    for name, src, test in (
        ("ffhq_encode", "ffhq", "celeba_test"),
        ("cars_encode", "cars_train", "cars_test"),
        ("church_encode", "church_train", "church_test"),
        ("horse_encode", "horse_train", "horse_test"),
        ("afhq_wild_encode", "afhq_wild_train", "afhq_wild_test"),
        ("toonify", "ffhq", "celeba_test"),
        ("AfrAsianFaceSet", "AfrAsianFaceSet", "celeba_test_112p"),
    )
}


def make_datasets(dataset_type: str,
                  demog_labels_file: Optional[str] = None):
    """(train, test) ``ImagesDataset`` pair of ``dataset_type``."""
    from .images_dataset import ImagesDataset
    cfg = DATASETS[dataset_type]
    t: TransformSpec = cfg["transforms"]
    train = ImagesDataset(cfg["train_source_root"], cfg["train_target_root"],
                          source_size=t.source_size, target_size=t.gt_size,
                          demog_labels_file=demog_labels_file)
    test = ImagesDataset(cfg["test_source_root"], cfg["test_target_root"],
                         source_size=t.source_size, target_size=t.test_size)
    return train, test
