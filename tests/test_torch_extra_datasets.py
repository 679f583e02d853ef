"""The port's extra segmentation datasets against the JAX package's on
synthetic roots: Cityscapes, ADE20K (with its label remap), COCO and
PASCAL-Context, registered by name. Names, images and (remapped) labels are
equal, and so are the weak-augmentation samples under the same seed."""

import numpy as np
import pytest
from PIL import Image

from wseg_tpu.seg.config import SegConfig as JaxSegConfig
from wseg_tpu.seg.dataset import generate_dataset as jax_generate_dataset
from wseg_tpu_torch.seg.config import SegConfig
from wseg_tpu_torch.seg.dataset import generate_dataset


def _save(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _img(rng, h, w):
    return (rng.rand(h, w, 3) * 255).astype(np.uint8)


def cityscapes(root, rng):
    for city, stems in (("aachen", ["aachen_000001_000019", "aachen_000000_000019"]),
                        ("bonn", ["bonn_000000_000019"])):
        for stem in stems:
            _save(root / "leftImg8bit" / "val" / city / f"{stem}_leftImg8bit.png",
                  _img(rng, 40, 72))
            _save(root / "gtFine" / "val" / city / f"{stem}_gtFine_labelTrainIds.png",
                  rng.choice([0, 5, 18, 255], (40, 72)).astype(np.uint8))
    return "CityscapesDataset", 19, "val"


def ade20k(root, rng):
    for i in range(2):
        _save(root / "images" / "validation" / f"ADE_val_{i:08d}.jpg", _img(rng, 48, 56))
        _save(root / "annotations" / "validation" / f"ADE_val_{i:08d}.png",
              rng.randint(0, 151, (48, 56)).astype(np.uint8))
    return "ADE20KDataset", 150, "val"


def coco(root, rng):
    for i in (3, 1):
        _save(root / "images" / "val2017" / f"{i:012d}.jpg", _img(rng, 36, 52))
        _save(root / "annotations" / "val2017" / f"{i:012d}.png",
              rng.choice([0, 17, 170, 255], (36, 52)).astype(np.uint8))
    return "COCODataset", 171, "val"


def context(root, rng):
    names = ["2008_000002", "2008_000007"]
    for name in names:
        _save(root / "JPEGImages" / f"{name}.jpg", _img(rng, 44, 60))
        _save(root / "SegmentationClassContext" / f"{name}.png",
              rng.randint(0, 60, (44, 60)).astype(np.uint8))
    sets = root / "ImageSets" / "SegmentationContext"
    sets.mkdir(parents=True)
    (sets / "val.txt").write_text("".join(n + "\n" for n in names))
    return "ContextDataset", 60, "val"


@pytest.mark.parametrize("layout", [cityscapes, ade20k, coco, context])
def test_extra_dataset_matches_jax(tmp_path, layout):
    name, n_classes, period = layout(tmp_path, np.random.RandomState(len(layout.__name__)))
    fields = dict(DATA_NAME=name, DATA_ROOT=str(tmp_path), DATA_RANDOMCROP=32,
                  MODEL_NUM_CLASSES=n_classes)
    for transform in ("none", "weak"):
        want_ds = jax_generate_dataset(JaxSegConfig(**fields), period, transform, det_seed=5)
        got_ds = generate_dataset(SegConfig(**fields), period, transform, det_seed=5)
        assert type(got_ds).__name__ == type(want_ds).__name__
        assert got_ds.name_list == want_ds.name_list and len(got_ds) >= 2
        assert got_ds.num_categories == want_ds.num_categories == n_classes
        for n in got_ds.name_list:
            np.testing.assert_array_equal(got_ds.load_image(n), want_ds.load_image(n))
            seg = got_ds.load_segmentation(n)
            assert seg.dtype == want_ds.load_segmentation(n).dtype
            np.testing.assert_array_equal(seg, want_ds.load_segmentation(n))
        for i in range(len(got_ds)):
            got, want = got_ds[i], want_ds[i]
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    if name == "ADE20KDataset":
        raw = np.array(Image.open(tmp_path / "annotations" / "validation" / "ADE_val_00000000.png"))
        seg = got_ds.load_segmentation("ADE_val_00000000")
        assert (seg[raw == 0] == 255).all() and (seg[raw > 0] == raw[raw > 0] - 1).all()
    if name == "CityscapesDataset":
        assert got_ds.name_list[0] == "aachen/aachen_000000_000019"
