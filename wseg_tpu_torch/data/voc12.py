"""PASCAL VOC 2012 lists, image-level labels and datasets (counterpart of
wseg_tpu/data/voc12.py): classification, stage-1 training, multi-scale (+
flip) inference, the saliency variant, and AffinityNet training from CRF
labels or from mask pngs.

Labels come from an explicit cls_labels.npy, a cached one next to the VOC
root (or the repo's voc12/), or the XML annotations, then cached. PIL is
imported where images are opened.
"""

from __future__ import annotations

import os

import numpy as np

from wseg_tpu_torch.data import transforms as T

IMG_FOLDER_NAME = "JPEGImages"
ANNOT_FOLDER_NAME = "Annotations"

CAT_LIST = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]
CAT_NAME_TO_NUM = {c: i for i, c in enumerate(CAT_LIST)}
CATEGORIES_WITH_BG = ["background"] + CAT_LIST


def get_img_path(img_name: str, voc12_root: str) -> str:
    return os.path.join(voc12_root, IMG_FOLDER_NAME, img_name + ".jpg")


def load_img_name_list(dataset_path: str) -> list[str]:
    """Parse a list file: the reference's '/JPEGImages/<id>.jpg ...' lines
    (image id = chars [-15:-4] of the jpg path) or bare names."""
    with open(dataset_path) as f:
        lines = f.read().splitlines()
    names = []
    for line in lines:
        if not line.strip():
            continue
        first = line.split(" ")[0]
        names.append(first[-15:-4] if first.endswith(".jpg") else first.strip())
    return names


def load_image_label_from_xml(img_name: str, voc12_root: str) -> np.ndarray:
    from xml.dom import minidom

    path = os.path.join(voc12_root, ANNOT_FOLDER_NAME, img_name + ".xml")
    lab = np.zeros(20, np.float32)
    for el in minidom.parse(path).getElementsByTagName("name"):
        cat = el.firstChild.data
        if cat in CAT_NAME_TO_NUM:
            lab[CAT_NAME_TO_NUM[cat]] = 1.0
    return lab


def load_image_label_list(
    img_name_list: list[str], voc12_root: str, cls_labels_path: str | None = None
) -> list[np.ndarray]:
    """Multi-hot labels for each image, from (in order of preference) an
    explicit cls_labels.npy, a cached one, or the XML annotations (then
    cached next to the VOC root)."""
    candidates = [cls_labels_path] if cls_labels_path else []
    candidates += [
        os.path.join(voc12_root, "cls_labels.npy"),
        os.path.join("voc12", "cls_labels.npy"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            d = np.load(cand, allow_pickle=True).item()
            if all(n in d for n in img_name_list):
                return [np.asarray(d[n], np.float32) for n in img_name_list]
    labels = {n: load_image_label_from_xml(n, voc12_root) for n in img_name_list}
    try:
        np.save(os.path.join(voc12_root, "cls_labels.npy"), labels)  # cache
    except OSError:
        pass
    return [labels[n] for n in img_name_list]


class VOC12ClsDataset:
    """Items are (name, PIL RGB image, label (20,))."""

    def __init__(self, img_name_list_path, voc12_root, cls_labels_path=None):
        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root
        self.label_list = load_image_label_list(self.img_name_list, voc12_root, cls_labels_path)

    def __len__(self):
        return len(self.img_name_list)

    def load_image(self, idx: int):
        import PIL.Image

        return PIL.Image.open(get_img_path(self.img_name_list[idx], self.voc12_root)).convert("RGB")

    def __getitem__(self, idx: int):
        return self.img_name_list[idx], self.load_image(idx), self.label_list[idx]


class ContrastTrainDataset(VOC12ClsDataset):
    """The stage-1 training pipeline (contrast_train.py:64-75):
    RandomResizeLong(min_long, max_long) -> flip -> ColorJitter -> normalize
    -> RandomCrop(crop_size). Items are (name, HWC float32 crop, label).

    det_seed: when set, sample idx of epoch e is augmented by its own
    `random.Random(f"{det_seed}:{e}:{idx}")`, the JAX package's seeding, so
    a sample is reproducible across processes and thread schedules (the
    epoch comes from `set_epoch`, which the DataLoader calls). None draws
    from the global `random` stream, as the reference does."""

    def __init__(self, img_name_list_path, voc12_root, crop_size=448, min_long=448,
                 max_long=768, cls_labels_path=None, det_seed: int | None = None):
        super().__init__(img_name_list_path, voc12_root, cls_labels_path)
        self.resize = T.RandomResizeLong(min_long, max_long)
        self.flip = T.RandomHorizontalFlip()
        self.jitter = T.ColorJitter(0.3, 0.3, 0.3, 0.1)
        self.normalize = T.Normalize()
        self.crop = T.RandomCrop(crop_size)
        self.det_seed = det_seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __getitem__(self, idx: int):
        import random

        rng = (random.Random(f"{self.det_seed}:{self._epoch}:{idx}")
               if self.det_seed is not None else None)
        img = self.flip(self.resize(self.load_image(idx), rng), rng)
        img = self.jitter(img, rng)
        return self.img_name_list[idx], self.crop(self.normalize(img), rng), self.label_list[idx]


class VOC12ClsDatasetMSF:
    """Multi-scale + flip views (voc12/data.py:92-121): for each scale,
    PIL-bicubic resize then [orig, flipped], normalized HWC float32.
    Items are (name, views, label, (H, W))."""

    def __init__(self, img_name_list_path, voc12_root, scales=(0.5, 1.0, 1.5, 2.0),
                 unit=1, cls_labels_path=None):
        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root
        self.label_list = load_image_label_list(
            self.img_name_list, voc12_root, cls_labels_path
        )
        self.scales = scales
        self.unit = unit
        self.normalize = T.Normalize()

    def __len__(self):
        return len(self.img_name_list)

    def load_image(self, idx: int):
        import PIL.Image

        name = self.img_name_list[idx]
        return PIL.Image.open(get_img_path(name, self.voc12_root)).convert("RGB")

    def __getitem__(self, idx: int):
        img = self.load_image(idx)
        views = [self.normalize(v) for v in T.msf_views(img, self.scales, self.unit)]
        return self.img_name_list[idx], views, self.label_list[idx], (img.size[1], img.size[0])


class VOC12ClsDatasetMS(VOC12ClsDatasetMSF):
    """Multi-scale views without the flips (voc12/data.py:123-147). Items
    are (name, views, label, (H, W))."""

    def __getitem__(self, idx: int):
        img = self.load_image(idx)
        views = T.msf_views(img, self.scales, self.unit)[::2]
        return (self.img_name_list[idx], [self.normalize(v) for v in views],
                self.label_list[idx], (img.size[1], img.size[0]))


class VOC12SaliencyDataset(VOC12ClsDataset):
    """Classification samples with an aligned saliency map, the `eps`
    branch's dataset (voc12/voc_saliency.py:59-86): grayscale pngs in
    `saliency_root`, resized, flipped and cropped jointly with the image.
    Items are (name, HWC float32 crop, (crop, crop, 1) map in [0, 1],
    label). `rng` (a `random.Random`) draws the augmentation; without one,
    the global `random` stream does, as in the JAX package."""

    def __init__(self, img_name_list_path, voc12_root, saliency_root, crop_size=448,
                 min_long=448, max_long=768, cls_labels_path=None, rng=None):
        super().__init__(img_name_list_path, voc12_root, cls_labels_path)
        self.saliency_root = saliency_root
        self.crop = T.RandomCrop(crop_size)
        self.jitter = T.ColorJitter(0.3, 0.3, 0.3, 0.1)
        self.normalize = T.Normalize()
        self.min_long = min_long
        self.max_long = max_long
        self.rng = rng

    def __getitem__(self, idx: int):
        import random

        import PIL.Image

        r = self.rng or random
        name, img = self.img_name_list[idx], self.load_image(idx)
        with PIL.Image.open(os.path.join(self.saliency_root, name + ".png")) as im:
            sal = im.convert("L")
        target_long = r.randint(self.min_long, self.max_long)
        w, h = img.size
        if w < h:
            shape = (int(round(w * target_long / h)), target_long)
        else:
            shape = (target_long, int(round(h * target_long / w)))
        img = img.resize(shape, PIL.Image.BICUBIC)
        sal = sal.resize(shape, PIL.Image.BICUBIC)
        if bool(r.getrandbits(1)):
            img = img.transpose(PIL.Image.FLIP_LEFT_RIGHT)
            sal = sal.transpose(PIL.Image.FLIP_LEFT_RIGHT)
        arr = self.normalize(self.jitter(img, self.rng))
        sal_arr = np.asarray(sal, np.float32)[..., None] / 255.0
        box = self.crop.get_box(*arr.shape[:2], rng=self.rng)
        return name, self.crop.apply(arr, box), self.crop.apply(sal_arr, box), self.label_list[idx]


class VOC12AffGtDataset:
    """AffinityNet samples from ground-truth (or pseudo) mask pngs
    (voc12/data.py:263-304): image + label png -> jitter, a joint crop
    (pad pixels labelled 255), normalize, a joint flip -> the label
    subsampled 8x (nearest) -> radius-pair affinity targets. Items are (HWC
    float32 crop, (bg_pos, fg_pos, neg)). `rng`: as VOC12SaliencyDataset."""

    def __init__(self, img_name_list_path, label_dir, voc12_root, cropsize=448, radius=5,
                 rng=None):
        from wseg_tpu_torch.data.affinity_labels import ExtractAffinityLabelInRadius

        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root
        self.label_dir = label_dir
        self.jitter = T.ColorJitter(0.3, 0.3, 0.3, 0.1)
        self.normalize = T.Normalize()
        self.crop = T.RandomCrop(cropsize)
        self.extract = ExtractAffinityLabelInRadius(cropsize // 8, radius)
        self.rng = rng

    def __len__(self):
        return len(self.img_name_list)

    def __getitem__(self, idx: int):
        import random

        import PIL.Image

        name = self.img_name_list[idx]
        img = PIL.Image.open(get_img_path(name, self.voc12_root)).convert("RGB")
        with PIL.Image.open(os.path.join(self.label_dir, name + ".png")) as im:
            label = np.asarray(im).astype(np.float32)[..., None]
        raw = np.asarray(self.jitter(img, self.rng), np.float32)
        box = self.crop.get_box(*raw.shape[:2], rng=self.rng)
        ct, cl, it_, il, ch, cw = box
        size = self.crop.cropsize
        lab = np.full((size, size, 1), 255.0, np.float32)
        lab[ct:ct + ch, cl:cl + cw] = label[it_:it_ + ch, il:il + cw]
        arr = self.normalize(self.crop.apply(raw, box))
        if bool((self.rng or random).getrandbits(1)):
            arr = np.fliplr(arr).copy()
            lab = np.fliplr(lab).copy()
        return arr, self.extract(lab[::8, ::8, 0].astype(np.uint8))


class VOC12AffDataset:
    """AffinityNet training samples (voc12/data.py:201-261): image + the
    fused low/high-alpha CRF pseudo label -> joint augmentation -> 8x pooled
    label -> radius-pair affinity targets. Items are (HWC float32 crop,
    (bg_pos, fg_pos, neg)).

    det_seed and set_epoch: as ContrastTrainDataset."""

    def __init__(self, img_name_list_path, label_la_dir, label_ha_dir, voc12_root,
                 cropsize=448, radius=5, det_seed: int | None = None):
        from wseg_tpu_torch.data.affinity_labels import ExtractAffinityLabelInRadius

        self.img_name_list = load_img_name_list(img_name_list_path)
        self.voc12_root = voc12_root
        self.label_la_dir = label_la_dir
        self.label_ha_dir = label_ha_dir
        self.jitter = T.ColorJitter(0.3, 0.3, 0.3, 0.1)
        self.normalize = T.Normalize()
        self.crop = T.RandomCrop(cropsize)
        self.label_pool = T.AvgPool2d(8)
        self.extract = ExtractAffinityLabelInRadius(cropsize // 8, radius)
        self.det_seed = det_seed
        self._epoch = 0

    def __len__(self):
        return len(self.img_name_list)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _load_label(self, folder: str, name: str) -> np.ndarray:
        """(21, h, w) scores: an aff_prepare array, or the reference's
        {class: map} dict saved as an object array (voc12/data.py:239-246)."""
        label = np.load(os.path.join(folder, name + ".npy"), allow_pickle=True)
        if label.dtype == object:
            label = np.array(list(label.item().values()))
        return label

    def __getitem__(self, idx: int):
        import random

        import PIL.Image

        rng = (random.Random(f"{self.det_seed}:{self._epoch}:{idx}")
               if self.det_seed is not None else None)
        name = self.img_name_list[idx]
        img = PIL.Image.open(get_img_path(name, self.voc12_root)).convert("RGB")
        label = np.concatenate([self._load_label(self.label_la_dir, name),
                                self._load_label(self.label_ha_dir, name)], axis=0)
        label = np.transpose(label, (1, 2, 0))  # (h, w, 42)

        # the reference's order (aff_train.py:42-60): jitter, a joint crop of
        # the RAW uint8 image (so pad pixels become normalize(0), not 0),
        # normalize, a joint flip
        img = self.jitter(img, rng)
        raw = np.asarray(img, np.float32)
        box = self.crop.get_box(*raw.shape[:2], rng=rng)
        raw = self.crop.apply(raw, box)
        label = self.crop.apply(label.astype(np.float32), box)
        arr = self.normalize(raw)
        if bool((rng or random).getrandbits(1)):
            arr = np.fliplr(arr).copy()
            label = np.fliplr(label).copy()
        label = self.label_pool(label)

        # la/ha fusion (voc12/data.py:251-258)
        no_score = np.max(label, -1) < 1e-5
        la, ha = np.array_split(label, 2, axis=-1)
        la = np.argmax(la, axis=-1).astype(np.uint8)
        ha = np.argmax(ha, axis=-1).astype(np.uint8)
        fused = la.copy()
        fused[la == 0] = 255  # low-alpha background: ignore
        fused[ha == 0] = 0    # high-alpha background: confident background
        fused[no_score] = 255
        return arr, self.extract(fused)
