"""More segmentation datasets: Cityscapes, ADE20K, COCO and PASCAL-Context
(counterpart of wseg_tpu/seg/extra_datasets.py).

The reference carries these under `segmentation/lib/datasets/` but leaves
them out of its registry (`datasets/__init__.py:2-5`); here, as in the JAX
package, they are registered. Each subclass supplies its directory layout,
name discovery and label mapping, and `GenericSegDataset` reuses the VOC
weak-augmentation and multi-scale pipeline (seg/dataset.py). PIL is
imported inside the functions that use it.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from wseg_tpu_torch.seg.config import SegConfig
from wseg_tpu_torch.seg.dataset import VOCSegDataset, _read_png
from wseg_tpu_torch.utils.registry import DATASETS


class GenericSegDataset(VOCSegDataset):
    """The VOC pipeline over another layout: subclasses set the folders
    (`_setup_dirs`), the names (`_discover_names`, or a `datalist` file), the
    class count and the file suffixes, and may remap pixel labels
    (`remap_segmentation`)."""

    NUM_CLASSES = 21
    IMG_EXT = ".jpg"
    SEG_EXT = ".png"

    def __init__(self, cfg: SegConfig, period: str, transform: str = "none",
                 datalist: str = "", det_seed: int | None = None):
        self.det_seed = det_seed
        self._epoch = 0
        self.cfg = cfg
        self.period = period
        self.transform = transform
        self.rst_dir = os.path.join(cfg.ROOT_DIR, "results", type(self).__name__)
        self.pseudo_gt_dir = cfg.DATA_PSEUDO_GT
        self.num_categories = self.NUM_CLASSES
        self.mean = np.asarray(cfg.DATA_MEAN, np.float32)
        self.std = np.asarray(cfg.DATA_STD, np.float32)
        self._setup_dirs(cfg, period)
        if datalist:
            with open(datalist) as f:
                self.name_list = [line.strip() for line in f.read().splitlines() if line.strip()]
        else:
            self.name_list = self._discover_names()

    def _setup_dirs(self, cfg: SegConfig, period: str):
        raise NotImplementedError

    def _discover_names(self) -> list[str]:
        raise NotImplementedError

    def _img_path(self, name: str) -> str:
        return os.path.join(self.img_dir, name + self.IMG_EXT)

    def _seg_path(self, name: str) -> str:
        return os.path.join(self.seg_dir, name + self.SEG_EXT)

    def remap_segmentation(self, seg: np.ndarray) -> np.ndarray:
        return seg

    def load_image(self, name: str) -> np.ndarray:
        from PIL import Image

        with Image.open(self._img_path(name)) as im:
            return np.array(im.convert("RGB"))

    def load_segmentation(self, name: str) -> np.ndarray:
        if self.pseudo_gt_dir and "train" in self.period:
            path = os.path.join(self.pseudo_gt_dir, name.replace("/", "_") + ".png")
        else:
            path = self._seg_path(name)
        return self.remap_segmentation(_read_png(path))

    def save_result(self, result_list, model_id: str):
        from wseg_tpu_torch.infer.cam import write_png

        folder = os.path.join(self.rst_dir, f"{model_id}_{self.period}")
        os.makedirs(folder, exist_ok=True)
        for sample in result_list:
            write_png(os.path.join(folder, sample["name"].replace("/", "_") + ".png"),
                      sample["predict"].astype(np.uint8))


@DATASETS.register("CityscapesDataset")
class CityscapesDataset(GenericSegDataset):
    """leftImg8bit/<split>/<city>/*_leftImg8bit.png with gtFine's
    labelTrainIds pngs (19 classes, 255 ignore)."""

    NUM_CLASSES = 19
    IMG_EXT = "_leftImg8bit.png"
    SEG_EXT = "_gtFine_labelTrainIds.png"

    def _setup_dirs(self, cfg, period):
        split = {"train": "train", "val": "val", "test": "test"}[period]
        self.img_dir = os.path.join(cfg.DATA_ROOT, "leftImg8bit", split)
        self.seg_dir = os.path.join(cfg.DATA_ROOT, "gtFine", split)

    def _discover_names(self):
        files = sorted(glob.glob(os.path.join(self.img_dir, "*", "*" + self.IMG_EXT)))
        prefix = self.img_dir.rstrip("/") + "/"
        return [f[len(prefix):][:-len(self.IMG_EXT)] for f in files]


@DATASETS.register("ADE20KDataset")
class ADE20KDataset(GenericSegDataset):
    """ADEChallengeData2016: images/<split>/*.jpg, annotations/<split>/*.png
    (150 classes; label 0, unlabelled, becomes 255 and the rest shift down
    by one)."""

    NUM_CLASSES = 150

    def _setup_dirs(self, cfg, period):
        split = {"train": "training", "val": "validation"}.get(period, period)
        self.img_dir = os.path.join(cfg.DATA_ROOT, "images", split)
        self.seg_dir = os.path.join(cfg.DATA_ROOT, "annotations", split)

    def _discover_names(self):
        files = sorted(glob.glob(os.path.join(self.img_dir, "*.jpg")))
        return [os.path.splitext(os.path.basename(f))[0] for f in files]

    def remap_segmentation(self, seg):
        seg = seg.astype(np.int32) - 1
        seg[seg < 0] = 255
        return seg.astype(np.uint8)


@DATASETS.register("COCODataset")
class COCODataset(GenericSegDataset):
    """The COCO-Stuff layout: images/<split>2017/*.jpg with
    annotations/<split>2017/*.png label maps (171 classes, 255 ignore)."""

    NUM_CLASSES = 171

    def _setup_dirs(self, cfg, period):
        split = {"train": "train2017", "val": "val2017"}.get(period, period)
        self.img_dir = os.path.join(cfg.DATA_ROOT, "images", split)
        self.seg_dir = os.path.join(cfg.DATA_ROOT, "annotations", split)

    def _discover_names(self):
        files = sorted(glob.glob(os.path.join(self.img_dir, "*.jpg")))
        return [os.path.splitext(os.path.basename(f))[0] for f in files]


@DATASETS.register("ContextDataset")
class ContextDataset(GenericSegDataset):
    """PASCAL-Context (60 classes): VOC's JPEGImages with label pngs in
    SegmentationClassContext, names from
    ImageSets/SegmentationContext/<period>.txt."""

    NUM_CLASSES = 60

    def _setup_dirs(self, cfg, period):
        self.img_dir = os.path.join(cfg.DATA_ROOT, "JPEGImages")
        self.seg_dir = os.path.join(cfg.DATA_ROOT, "SegmentationClassContext")
        self._set_file = os.path.join(cfg.DATA_ROOT, "ImageSets", "SegmentationContext",
                                      period + ".txt")

    def _discover_names(self):
        with open(self._set_file) as f:
            return [line.strip() for line in f.read().splitlines() if line.strip()]
