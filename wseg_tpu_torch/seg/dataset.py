"""Stage-3 VOC dataset + sample-dict transform pipeline (host-side, cv2;
counterpart of wseg_tpu/seg/dataset.py, with cv2 and PIL imported inside the
functions that use them).

Rebuild of `segmentation/lib/datasets/{BaseDataset,VOCDataset,transform}.py`:
weak augmentation HSV -> flip -> scale -> norm -> crop (BaseDataset.py:88-99)
with the reference's exact cv2 semantics (HSV jitter with H mod 180,
transform.py:76-101; cubic image / nearest label rescale :126-149; zero-pad
image / 255-pad label random crop :12-74), and the test-time `Multiscale`
view generator. Samples are dicts with HWC float32 images; the CLIs make NCHW views of them
on the device.
"""

from __future__ import annotations

import os
import random

import numpy as np

from wseg_tpu_torch.data.voc12 import CAT_LIST
from wseg_tpu_torch.seg.config import SegConfig
from wseg_tpu_torch.utils.registry import DATASETS


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def random_hsv(image: np.ndarray, h_r: int, s_r: int, v_r: int,
               rng=None) -> np.ndarray:
    import cv2

    r_ = rng or random
    hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)
    h = hsv[:, :, 0].astype(np.int32)
    s = hsv[:, :, 1].astype(np.int32)
    v = hsv[:, :, 2].astype(np.int32)
    h = (h + r_.randint(-h_r, h_r)) % 180
    s = np.clip(s + r_.randint(-s_r, s_r), 0, 255)
    v = np.clip(v + r_.randint(-v_r, v_r), 0, 255)
    hsv = np.stack([h, s, v], axis=-1).astype(np.uint8)
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.uint8)


def random_scale(image, seg, scale_range, rng=None) -> tuple[np.ndarray, np.ndarray]:
    import cv2

    r = (rng or random).random() * (scale_range[1] - scale_range[0]) + scale_range[0]
    image = cv2.resize(image, None, fx=r, fy=r, interpolation=cv2.INTER_CUBIC)
    seg = cv2.resize(seg, None, fx=r, fy=r, interpolation=cv2.INTER_NEAREST)
    return image, seg


def random_crop(image, seg, size: int, rng=None):
    r_ = rng or random
    h, w = image.shape[:2]
    ch, cw = min(h, size), min(w, size)
    h_space, w_space = h - size, w - size
    if w_space > 0:
        cont_left, img_left = 0, r_.randrange(w_space + 1)
    else:
        cont_left, img_left = r_.randrange(-w_space + 1), 0
    if h_space > 0:
        cont_top, img_top = 0, r_.randrange(h_space + 1)
    else:
        cont_top, img_top = r_.randrange(-h_space + 1), 0
    img_crop = np.zeros((size, size, 3), np.float32)
    img_crop[cont_top : cont_top + ch, cont_left : cont_left + cw] = image[
        img_top : img_top + ch, img_left : img_left + cw
    ]
    seg_crop = np.full((size, size), 255, np.float32)
    seg_crop[cont_top : cont_top + ch, cont_left : cont_left + cw] = seg[
        img_top : img_top + ch, img_left : img_left + cw
    ]
    return img_crop, seg_crop


def voc_colormap(n: int = 256) -> np.ndarray:
    """The standard VOC label colormap (bit-twiddling form used at
    tool/visualization.py:100-108 / VOCDataset.label2colormap)."""
    m = np.arange(n, dtype=np.uint8)
    cmap = np.zeros((n, 3), np.uint8)
    cmap[:, 0] = (m & 1) << 7 | (m & 8) << 3
    cmap[:, 1] = (m & 2) << 6 | (m & 16) << 2
    cmap[:, 2] = (m & 4) << 5
    return cmap


@DATASETS.register("VOCDataset")
class VOCSegDataset:
    """period: 'train'/'val'/'test'; transform: 'weak'/'none'."""

    def __init__(self, cfg: SegConfig, period: str, transform: str = "none",
                 datalist: str = "", det_seed: int | None = None):
        # det_seed: epoch-indexed deterministic augmentation, the same
        # contract as ContrastTrainDataset (data/voc12.py)
        self.det_seed = det_seed
        self._epoch = 0
        self.cfg = cfg
        self.period = period
        self.transform = transform
        self.dataset_dir = cfg.DATA_ROOT
        self.img_dir = os.path.join(self.dataset_dir, "JPEGImages")
        self.seg_dir = os.path.join(self.dataset_dir, "SegmentationClass")
        self.set_dir = os.path.join(self.dataset_dir, "ImageSets", "Segmentation")
        self.rst_dir = os.path.join(cfg.ROOT_DIR, "results", "Segmentation")
        self.pseudo_gt_dir = cfg.DATA_PSEUDO_GT
        self.num_categories = len(CAT_LIST) + 1
        self.mean = np.asarray(cfg.DATA_MEAN, np.float32)
        self.std = np.asarray(cfg.DATA_STD, np.float32)

        if datalist:
            file_name = datalist
        elif cfg.DATA_AUG and "train" in period:
            file_name = os.path.join(self.set_dir, period + "aug.txt")
        else:
            file_name = os.path.join(self.set_dir, period + ".txt")
        with open(file_name) as f:
            self.name_list = [line.strip() for line in f.read().splitlines() if line.strip()]

    def __len__(self):
        return len(self.name_list)

    def load_image(self, name: str) -> np.ndarray:
        from PIL import Image

        with Image.open(os.path.join(self.img_dir, name + ".jpg")) as im:
            return np.array(im.convert("RGB"))

    def load_segmentation(self, name: str) -> np.ndarray:
        if self.pseudo_gt_dir and "train" in self.period:
            path = os.path.join(self.pseudo_gt_dir, name + ".png")
        else:
            path = os.path.join(self.seg_dir, name + ".png")
        return _read_png(path)

    def normalize(self, image: np.ndarray) -> np.ndarray:
        return (image.astype(np.float32) / 255.0 - self.mean) / self.std

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __getitem__(self, idx: int) -> dict:
        cfg = self.cfg
        rng = (
            random.Random(f"{self.det_seed}:{self._epoch}:{idx}")
            if self.det_seed is not None else None
        )
        name = self.name_list[idx]
        image = self.load_image(name)
        r, c = image.shape[:2]
        sample = {"name": name, "row": r, "col": c}

        if self.transform == "weak":
            seg = self.load_segmentation(name).astype(np.float32)
            if cfg.DATA_RANDOM_H or cfg.DATA_RANDOM_S or cfg.DATA_RANDOM_V:
                image = random_hsv(image, cfg.DATA_RANDOM_H, cfg.DATA_RANDOM_S,
                                   cfg.DATA_RANDOM_V, rng)
            if cfg.DATA_RANDOMFLIP > 0 and (rng or random).random() < cfg.DATA_RANDOMFLIP:
                image = np.flip(image, axis=1)
                seg = np.flip(seg, axis=1)
            if tuple(cfg.DATA_RANDOMSCALE) != (1, 1):
                image, seg = random_scale(image, seg, cfg.DATA_RANDOMSCALE, rng)
            image = self.normalize(image)
            if cfg.DATA_RANDOMCROP > 0:
                image, seg = random_crop(image, seg, cfg.DATA_RANDOMCROP, rng)
            sample["image"] = image.astype(np.float32)
            sample["segmentation"] = seg.astype(np.int32)
        else:  # test-time: normalized multi-scale views (BaseDataset Multiscale)
            import cv2

            norm = self.normalize(image)
            sample["image"] = norm
            for rate in cfg.TEST_MULTISCALE:
                v = cv2.resize(norm, None, fx=rate, fy=rate, interpolation=cv2.INTER_CUBIC)
                sample["image_%f" % rate] = v.astype(np.float32)
            if "val" in self.period or "train" in self.period:
                try:
                    sample["segmentation"] = _read_png(os.path.join(self.seg_dir, name + ".png"))
                except FileNotFoundError:
                    pass
        return sample

    def label2colormap(self, label: np.ndarray) -> np.ndarray:
        cmap = voc_colormap()
        out = cmap[np.clip(label, 0, 255).astype(np.uint8)]
        out[label == 255] = 255
        return out

    def save_result(self, result_list, model_id: str):
        from wseg_tpu_torch.infer.cam import write_png

        folder = os.path.join(self.rst_dir, f"{model_id}_{self.period}")
        os.makedirs(folder, exist_ok=True)
        for sample in result_list:
            write_png(os.path.join(folder, "%s.png" % sample["name"]),
                      sample["predict"].astype(np.uint8))

    def do_python_eval(self, model_id: str, group=None) -> dict:
        """mIoU of the saved predictions; with a process `group`, each rank
        reads its block of the list (parallel/mesh.py:shard_indices) and the
        confusion matrices are summed over the ranks."""
        from wseg_tpu_torch.eval.miou import do_python_eval
        from wseg_tpu_torch.parallel.mesh import shard_indices

        folder = os.path.join(self.rst_dir, f"{model_id}_{self.period}")
        names = [self.name_list[i] for i in shard_indices(len(self.name_list), group)]
        return do_python_eval(folder, self.seg_dir, names, printlog=True, group=group)


def generate_dataset(cfg: SegConfig, period: str, transform: str = "none", **kw):
    """The registered dataset of `cfg.DATA_NAME`: VOC, or one of
    seg/extra_datasets.py's."""
    from wseg_tpu_torch.seg import extra_datasets  # noqa: F401  (registers them)

    return DATASETS.get(cfg.DATA_NAME)(cfg, period, transform, **kw)
