"""Stage-3 segmentation configuration (a copy of wseg_tpu/seg/config.py).

Replaces the reference's per-experiment `config_dict` + `Configuration`
(segmentation/experiment/*/config.py, lib/utils/configuration.py) with one
dataclass; the three reference experiments ship as presets in `EXPERIMENTS`
with their exact hyperparameters (SEAM_deeplabv1_resnet38/config.py:11-62,
EPS_deeplabv1_resnet101/config.py, EPS_deeplabv2_resnet101/config.py).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field


@dataclass
class SegConfig:
    EXP_NAME: str = "SEAM_deeplabv1_resnet38"

    DATA_NAME: str = "VOCDataset"
    DATA_YEAR: int = 2012
    DATA_AUG: bool = True
    DATA_WORKERS: int = 4
    DATA_MEAN: tuple = (0.485, 0.456, 0.406)
    DATA_STD: tuple = (0.229, 0.224, 0.225)
    DATA_RANDOMCROP: int = 448
    DATA_RANDOMSCALE: tuple = (0.5, 1.5)
    DATA_RANDOM_H: int = 10
    DATA_RANDOM_S: int = 10
    DATA_RANDOM_V: int = 10
    DATA_RANDOMFLIP: float = 0.5
    DATA_PSEUDO_GT: str = ""  # dir of random-walk pseudo masks
    DATA_ROOT: str = "VOC2012"

    MODEL_NAME: str = "deeplabv1"
    MODEL_BACKBONE: str = "resnet38"
    MODEL_BACKBONE_PRETRAIN: bool = True
    MODEL_BACKBONE_WEIGHTS: str = ""  # checkpoint path for the backbone
    MODEL_NUM_CLASSES: int = 21
    MODEL_FREEZEBN: bool = False
    MODEL_ASPP_OUTDIM: int = 256
    MODEL_ASPP_HASGLOBAL: bool = False
    MODEL_SHORTCUT_DIM: int = 48
    MODEL_OUTPUT_STRIDE: int = 8

    TRAIN_LR: float = 0.001
    TRAIN_MOMENTUM: float = 0.9
    TRAIN_WEIGHT_DECAY: float = 5e-4
    TRAIN_BN_MOM: float = 3e-4
    TRAIN_POWER: float = 0.9
    TRAIN_BATCHES: int = 10
    TRAIN_SHUFFLE: bool = True
    TRAIN_MINEPOCH: int = 0
    TRAIN_ITERATION: int = 20000
    TRAIN_TBLOG: bool = True
    TRAIN_CKPT: str = ""

    TEST_MULTISCALE: tuple = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
    TEST_FLIP: bool = True
    TEST_CRF: bool = True
    TEST_BATCHES: int = 1
    TEST_CKPT: str = ""

    ROOT_DIR: str = "."

    @property
    def MODEL_SAVE_DIR(self) -> str:
        return os.path.join(self.ROOT_DIR, "model", self.EXP_NAME)

    @property
    def LOG_DIR(self) -> str:
        return os.path.join(self.ROOT_DIR, "log", self.EXP_NAME)

    def replace(self, **kw) -> "SegConfig":
        return dataclasses.replace(self, **kw)


EXPERIMENTS = {
    # SEAM path: DeepLab v1 on ResNet-38 (SEAM_deeplabv1_resnet38/config.py)
    "SEAM_deeplabv1_resnet38": SegConfig(),
    # EPS path: DeepLab v1 on ResNet-101 (EPS_deeplabv1_resnet101/config.py)
    "EPS_deeplabv1_resnet101": SegConfig(
        EXP_NAME="EPS_deeplabv1_resnet101",
        MODEL_BACKBONE="resnet101",
    ),
    # EPS path: DeepLab v2 on ResNet-101 (EPS_deeplabv2_resnet101/config.py:
    # ASPP_OUTDIM 256, HASGLOBAL True, batch 12)
    "EPS_deeplabv2_resnet101": SegConfig(
        EXP_NAME="EPS_deeplabv2_resnet101",
        MODEL_NAME="deeplabv2",
        MODEL_BACKBONE="resnet101",
        MODEL_ASPP_OUTDIM=256,
        MODEL_ASPP_HASGLOBAL=True,
        TRAIN_BATCHES=12,
    ),
}
