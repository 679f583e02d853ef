"""The port's stage-3 dataset against the JAX package's on a random VOC root:
the weak training pipeline (HSV jitter, flip, cubic / nearest rescale,
normalise, zero / 255-padded crop) under the same `det_seed` and epoch, the
multiscale test views, the loader's batches, the colormaps, the image
writer. Both sides call the same cv2, so everything is bit-equal."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from wseg_tpu.seg.config import EXPERIMENTS as JAX_EXPERIMENTS
from wseg_tpu.seg.dataset import generate_dataset as jax_generate_dataset
from wseg_tpu_torch.seg.config import EXPERIMENTS
from wseg_tpu_torch.seg.dataset import generate_dataset

SIZES = [(75, 93), (120, 61), (48, 40), (90, 110)]


def make_seg_root(root, sizes=SIZES, seed=0, n_labels=21):
    """A VOC seg root: random JPEGs, SegmentationClass pngs (with 255
    borders), a pseudo-mask dir, and `trainaug.txt` / `val.txt` lists.
    Returns (voc root, pseudo-mask dir, names)."""
    rng = np.random.RandomState(seed)
    voc = os.path.join(root, "VOC2012")
    for d in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(os.path.join(voc, d))
    pseudo = os.path.join(root, "pseudo")
    os.makedirs(pseudo)
    names = []
    for i, (h, w) in enumerate(sizes):
        name = f"2007_{i:06d}"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(voc, "JPEGImages", name + ".jpg"))
        gt = rng.randint(0, n_labels, (h, w)).astype(np.uint8)
        gt[:2] = 255
        Image.fromarray(gt).save(os.path.join(voc, "SegmentationClass", name + ".png"))
        Image.fromarray(rng.randint(0, n_labels, (h, w)).astype(np.uint8)).save(
            os.path.join(pseudo, name + ".png"))
        names.append(name)
    for lst in ("trainaug.txt", "val.txt"):
        with open(os.path.join(voc, "ImageSets", "Segmentation", lst), "w") as f:
            f.write("".join(n + "\n" for n in names))
    return voc, pseudo, names


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_seg_root(str(tmp_path_factory.mktemp("seg")))


@pytest.mark.parametrize("crop", [64, 96])
def test_weak_samples_equal_jax(root, crop):
    """Same det_seed and epoch: every sample's crop, label and metadata
    bit-equal to the JAX package's, for crops smaller and larger than the
    images (the zero / 255 padding)."""
    voc, pseudo, names = root
    kw = dict(DATA_ROOT=voc, DATA_PSEUDO_GT=pseudo, DATA_RANDOMCROP=crop)
    want_ds = jax_generate_dataset(JAX_EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(**kw),
                                   "train", "weak", det_seed=3)
    got_ds = generate_dataset(EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(**kw),
                              "train", "weak", det_seed=3)
    assert got_ds.name_list == want_ds.name_list == names
    for epoch in (0, 2):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        for i in range(len(names)):
            got, want = got_ds[i], want_ds[i]
            assert got.keys() == want.keys()
            assert got["image"].dtype == np.float32 and got["image"].shape == (crop, crop, 3)
            np.testing.assert_array_equal(got["image"], want["image"])
            assert got["segmentation"].dtype == np.int32
            np.testing.assert_array_equal(got["segmentation"], want["segmentation"])
            assert (got["name"], got["row"], got["col"]) == (want["name"], want["row"],
                                                           want["col"])
    got_ds.set_epoch(0)
    labels = np.concatenate([got_ds[i]["segmentation"].ravel() for i in range(len(names))])
    assert (labels == 255).any() and (labels < 21).any()


def test_multiscale_views_equal_jax(root):
    """The six normalised test views of each image (cubic resizes of the
    float image) and its ground truth, bit-equal."""
    voc, _, names = root
    want_ds = jax_generate_dataset(
        JAX_EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(DATA_ROOT=voc), "val")
    got_ds = generate_dataset(EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(DATA_ROOT=voc),
                              "val")
    for i, (h, w) in enumerate(SIZES):
        got, want = got_ds[i], want_ds[i]
        assert got.keys() == want.keys()
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k
        assert got["image_1.750000"].shape == (round(h * 1.75), round(w * 1.75), 3)


def test_loader_batches_equal_jax(root):
    """seg_train's loader (shuffled, last partial batch dropped, epoch-
    seeded) yields the JAX CLI's batches."""
    from wseg_tpu.data.loader import DataLoader as JaxLoader
    from wseg_tpu_torch.cli.seg_train import collate
    from wseg_tpu_torch.data.loader import DataLoader

    voc, pseudo, _ = root
    kw = dict(DATA_ROOT=voc, DATA_PSEUDO_GT=pseudo, DATA_RANDOMCROP=64)
    want_ds = jax_generate_dataset(JAX_EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(**kw),
                                   "train", "weak", det_seed=1)
    got_ds = generate_dataset(EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(**kw),
                              "train", "weak", det_seed=1)
    loaders = [JaxLoader(want_ds, 3, shuffle=True, drop_last=True, num_workers=2,
                         collate=collate, seed=1),
               DataLoader(got_ds, 3, num_workers=2, seed=1, collate=collate)]
    for epoch in (0, 1):
        batches = []
        for loader in loaders:
            loader.set_epoch(epoch)
            batches.append(list(loader))
        assert len(batches[0]) == len(batches[1]) == 1
        for a, b in zip(batches[0][0], batches[1][0]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_colormaps_and_denorm_equal_jax(root):
    """label2colormap (255 white), voc_label2colormap and img_denorm."""
    from wseg_tpu.utils.visualization import img_denorm as jax_img_denorm
    from wseg_tpu.utils.visualization import voc_label2colormap as jax_label2colormap
    from wseg_tpu_torch.utils.visualization import img_denorm, voc_label2colormap

    rng = np.random.RandomState(2)
    label = rng.randint(0, 21, (13, 17)).astype(np.int32)
    label[0] = 255
    voc = root[0]
    cmap = generate_dataset(EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(DATA_ROOT=voc),
                            "val").label2colormap(label)
    want = jax_generate_dataset(JAX_EXPERIMENTS["SEAM_deeplabv1_resnet38"].replace(
        DATA_ROOT=voc), "val").label2colormap(label)
    np.testing.assert_array_equal(cmap, want)
    assert (cmap[0] == 255).all() and cmap.dtype == np.uint8
    np.testing.assert_array_equal(voc_label2colormap(label), jax_label2colormap(label))
    img = rng.randn(3, 8, 9).astype(np.float32)
    for x in (img, img.transpose(1, 2, 0)):
        np.testing.assert_array_equal(img_denorm(x), jax_img_denorm(x))


def test_scalar_writer_add_image(tmp_path):
    """add_image writes `<logdir>/images/<tag>_<step>.png` (uint8 as is,
    [0, 1] floats scaled, CHW transposed) and an event naming it."""
    from wseg_tpu_torch.utils.logging import ScalarWriter

    writer = ScalarWriter(str(tmp_path))
    rgb = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    writer.add_image("Input", rgb, 100)
    writer.add_image("a/b", np.full((3, 5, 7), 0.5, np.float32), 7, dataformats="CHW")
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "images" / "Input_00000100.png")), rgb)
    half = np.asarray(Image.open(tmp_path / "images" / "a_b_00000007.png"))
    assert half.shape == (5, 7, 3) and (half == 128).all()
    events = [json.loads(line) for line in open(tmp_path / "events.jsonl")]
    assert events[0]["step"] == 100 and events[0]["image/Input"].endswith("Input_00000100.png")
