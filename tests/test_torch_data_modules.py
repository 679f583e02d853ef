"""The port's smaller data and visualisation modules against the JAX
package's, on a synthetic VOC root: the multi-scale, saliency and mask-png
affinity datasets item for item under the same `random` seed (and the same
items from an explicit `rng`), `CenterCrop`, the simple segmentation
dataset, and the visualisation functions bit for bit."""

import random

import numpy as np
import pytest
from PIL import Image

from wseg_tpu.data import transforms as jT
from wseg_tpu.data import voc12 as jvoc
from wseg_tpu.data.segmentation import SegmentationDataset as JaxSegmentationDataset
from wseg_tpu.utils import visualization as jvis
from wseg_tpu_torch.data import transforms as tT
from wseg_tpu_torch.data import voc12 as tvoc
from wseg_tpu_torch.data.segmentation import SegmentationDataset
from wseg_tpu_torch.utils import visualization as tvis

SIZES = [(48, 40), (70, 90), (56, 64)]
CATS = ["dog", "cat", "person"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """JPEGs with XML labels, grayscale saliency pngs and mask pngs (labels
    0..20 and 255). Returns (voc root, list file, saliency dir, label dir)."""
    base = tmp_path_factory.mktemp("voc_small")
    voc = base / "VOC2012"
    for d in ("JPEGImages", "Annotations", "sal", "labels"):
        (voc / d).mkdir(parents=True)
    rng = np.random.RandomState(0)
    names = []
    for i, ((h, w), cat) in enumerate(zip(SIZES, CATS)):
        name = f"2007_{i:06d}"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            voc / "JPEGImages" / f"{name}.jpg")
        (voc / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><object><name>{cat}</name></object></annotation>")
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(voc / "sal" / f"{name}.png")
        lab = rng.choice([0, 0, 3, 12, 255], size=(h, w)).astype(np.uint8)
        Image.fromarray(lab).save(voc / "labels" / f"{name}.png")
        names.append(name)
    lst = base / "list.txt"
    lst.write_text("".join(n + "\n" for n in names))
    return str(voc), str(lst), str(voc / "sal"), str(voc / "labels")


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _datasets(kind, root):
    voc, lst, sal, labels = root
    if kind == "ms":
        return jvoc.VOC12ClsDatasetMS(lst, voc), (lambda rng: tvoc.VOC12ClsDatasetMS(lst, voc))
    if kind == "saliency":
        return (jvoc.VOC12SaliencyDataset(lst, voc, sal, crop_size=64, min_long=40, max_long=80),
                lambda rng: tvoc.VOC12SaliencyDataset(lst, voc, sal, crop_size=64, min_long=40,
                                                      max_long=80, rng=rng))
    return (jvoc.VOC12AffGtDataset(lst, labels, voc, cropsize=64, radius=5),
            lambda rng: tvoc.VOC12AffGtDataset(lst, labels, voc, cropsize=64, radius=5, rng=rng))


@pytest.mark.parametrize("kind", ["ms", "saliency", "aff_gt"])
def test_voc12_datasets_match_jax_item_for_item(root, kind):
    """Each item, under `random.seed(s)` on both sides, equals the JAX
    package's bit for bit; the port's item from `rng=random.Random(s)` is
    the same again."""
    want_ds, make = _datasets(kind, root)
    got_ds = make(None)
    assert len(got_ds) == len(want_ds) == len(SIZES)
    for i in range(len(SIZES)):
        random.seed(100 + i)
        want = want_ds[i]
        random.seed(100 + i)
        got = got_ds[i]
        _equal(got, want)
        _equal(make(random.Random(100 + i))[i], want)
    if kind == "ms":
        assert len(got[1]) == 4 and got[3] == SIZES[-1]


@pytest.mark.parametrize("shape,size,fill", [
    ((9, 13, 3), 7, 0), ((5, 6, 3), 8, 0), ((9, 4), 6, 255), ((10, 10), 10, 0),
    ((6, 11, 2), 8, 7),
])
def test_center_crop_matches_jax(shape, size, fill):
    """Larger, smaller, mixed and equal sizes, HW and HWC, integer fills."""
    img = np.random.RandomState(sum(shape)).randint(0, 200, shape).astype(np.uint8)
    got = tT.CenterCrop(size, fill)(img)
    _equal(got, jT.CenterCrop(size, fill)(img))
    assert got.shape[:2] == (size, size)


@pytest.mark.parametrize("kw", [dict(), dict(rescale=(0.7, 1.3), cropsize=48, flip=True),
                                dict(cropsize=96, flip=True)])
def test_segmentation_dataset_matches_jax(root, kw):
    """Same global seed: name, image and the stride-8 mask equal the JAX
    package's (whose mask-resize fix the port keeps: the mask is resized
    with NEAREST, never the image in its place)."""
    voc, lst, _, labels = root
    img_dir = voc + "/JPEGImages"
    want_ds = JaxSegmentationDataset(lst, img_dir, labels, **kw)
    got_ds = SegmentationDataset(lst, img_dir, labels, **kw)
    for i in range(len(SIZES)):
        random.seed(7 + i)
        want = want_ds[i]
        random.seed(7 + i)
        got = got_ds[i]
        _equal(got, want)
        _equal(SegmentationDataset(lst, img_dir, labels, rng=random.Random(7 + i), **kw)[i], want)
        assert set(np.unique(got[2])) <= {0, 3, 12, 255}


@pytest.mark.parametrize("shape", [(3, 9, 11), (2, 3, 9, 11)])
def test_max_norm_np_matches_jax(shape):
    p = np.random.RandomState(1).randn(*shape).astype(np.float32)
    _equal(tvis.max_norm_np(p), jvis.max_norm_np(p))


def test_colour_functions_match_jax():
    """color_pro (HWC and CHW, with and without an image), color_cam and
    color_cls, bit for bit."""
    rng = np.random.RandomState(2)
    prob = rng.rand(4, 12, 17).astype(np.float32)
    img_chw = (rng.rand(3, 12, 17) * 255).astype(np.uint8)
    img_hwc = np.ascontiguousarray(img_chw.transpose(1, 2, 0))
    _equal(tvis.color_pro(prob[0]), jvis.color_pro(prob[0]))
    _equal(tvis.color_pro(prob[1], img_hwc), jvis.color_pro(prob[1], img_hwc))
    _equal(tvis.color_pro(prob[2], img_chw, mode="chw"), jvis.color_pro(prob[2], img_chw,
                                                                         mode="chw"))
    _equal(tvis.color_cam(prob, img_chw), jvis.color_cam(prob, img_chw))
    _equal(tvis.color_cls(prob), jvis.color_cls(prob))
    assert tvis.color_cam(prob, img_chw).shape == (4, 3, 12, 17)
