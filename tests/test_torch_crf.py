"""The port's ctypes binding of the native CRF (ops/densecrf.py) and its CRF
post-processing (infer/crf_post.py) against the JAX package's, on the CPU:
the same C++ sources, so the same bits. Inputs are numpy-seeded."""

import os

import numpy as np
import pytest

from wseg_tpu.infer import crf_post as jpost
from wseg_tpu.ops import densecrf as jcrf
from wseg_tpu_torch.infer import crf_post as tpost
from wseg_tpu_torch.ops import densecrf as tcrf


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_library_builds_outside_native():
    """The port builds into build/wseg_tpu_torch/, never into native/."""
    path = tcrf.library_path()
    tcrf._load()
    assert path.exists() and path.parent == tcrf.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "wseg_tpu_torch")
    assert not str(path).startswith(str(tcrf.NATIVE_DIR))


@pytest.mark.parametrize("d", [2, 5])
def test_permutohedral_filter_bitwise(d):
    rng = np.random.RandomState(d)
    feats = rng.rand(300, d).astype(np.float32) * 4
    vals = rng.rand(300, 3).astype(np.float32)
    np.testing.assert_array_equal(tcrf.permutohedral_filter(feats, vals),
                                  jcrf.permutohedral_filter(feats, vals))


def test_label_crfs_bitwise():
    """Single, multi (an alpha sweep's stack) and the AdvCAM parameters."""
    h, w = 30, 41
    img = _image(h, w, 0)
    labels = np.random.RandomState(1).randint(0, 21, size=(3, h, w)).astype(np.uint8)
    np.testing.assert_array_equal(tcrf.crf_inference_labels(img, labels[0], t=3),
                                  jcrf.crf_inference_labels(img, labels[0], t=3))
    kw = dict(t=4, sxy_bilateral=80, srgb=13)
    np.testing.assert_array_equal(tcrf.crf_inference_labels_multi(img, labels, **kw),
                                  jcrf.crf_inference_labels_multi(img, labels, **kw))
    np.testing.assert_array_equal(tcrf.unary_from_labels(labels[1], 21, 0.7),
                                  jcrf.unary_from_labels(labels[1], 21, 0.7))


def test_softmax_crfs_bitwise():
    h, w = 25, 33
    img = _image(h, w, 2)
    logits = np.random.RandomState(3).randn(21, h, w).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
    np.testing.assert_array_equal(tcrf.crf_inference_softmax(img, probs, t=2, scale_factor=2),
                                  jcrf.crf_inference_softmax(img, probs, t=2, scale_factor=2))
    np.testing.assert_array_equal(tcrf.dense_crf(probs, img), jcrf.dense_crf(probs, img))


@pytest.fixture
def cam_and_image(tmp_path):
    from PIL import Image

    h, w = 37, 52
    path = str(tmp_path / "img.jpg")
    Image.fromarray(_image(h, w, 4)).save(path)
    rng = np.random.RandomState(5)
    return {c: rng.rand(h, w).astype(np.float32) for c in (3, 11, 14)}, path


def test_crf_post_equals_jax(cam_and_image, tmp_path):
    """The alpha sweep (image-major), one alpha, and the contrast_infer CRF
    png: equal to the JAX package's, bit for bit."""
    from PIL import Image

    cam_dict, path = cam_and_image
    alphas = [4, 8, 16, 24, 32]
    got = tpost.crf_with_alpha_sweep(cam_dict, path, alphas, t=3)
    want = jpost.crf_with_alpha_sweep(cam_dict, path, alphas, t=3)
    assert len(got) == len(want) == len(alphas)
    for g, w in zip(got, want):
        assert g.shape == (21, 37, 52)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tpost.crf_with_alpha(cam_dict, path, 24, t=3), want[3])

    out_t, out_j = str(tmp_path / "t" / "x.png"), str(tmp_path / "j" / "x.png")
    pred = tpost.crf_from_cam_dict(cam_dict, path, out_t, t=3)
    jpost.crf_from_cam_dict(cam_dict, path, out_j, t=3)
    got_png, want_png = np.asarray(Image.open(out_t)), np.asarray(Image.open(out_j))
    assert got_png.dtype == np.uint8 and got_png.shape == (37, 52)
    np.testing.assert_array_equal(got_png, want_png)
    np.testing.assert_array_equal(pred, got_png)


def test_accelerator_backend_raises(cam_and_image, tmp_path):
    """backend "tpu" runs the accelerator CRF on the device it is given: on
    the CPU, the sweep's scores within 1e-4 of the JAX crf_post's tpu
    backend with the same argmax, and the same png. On the default device
    without a card it raises before any work; nothing falls back to the
    native CRF. An unknown backend raises."""
    import torch
    from PIL import Image

    cam_dict, path = cam_and_image
    got = tpost.crf_with_alpha_sweep(cam_dict, path, [4, 24], t=3, backend="tpu", device="cpu")
    want = jpost.crf_with_alpha_sweep(cam_dict, path, [4, 24], t=3, backend="tpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(g - w).max() <= 1e-4
        np.testing.assert_array_equal(g.argmax(0), w.argmax(0))
    out_t, out_j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tpost.crf_from_cam_dict(cam_dict, path, out_t, t=3, backend="tpu", device="cpu")
    jpost.crf_from_cam_dict(cam_dict, path, out_j, t=3, backend="tpu")
    np.testing.assert_array_equal(np.asarray(Image.open(out_t)), np.asarray(Image.open(out_j)))
    if not torch.cuda.is_available():
        out = str(tmp_path / "x.png")
        for call in (lambda: tpost.crf_with_alpha_sweep(cam_dict, path, [4], backend="tpu"),
                     lambda: tpost.crf_from_cam_dict(cam_dict, path, out, backend="tpu")):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        assert not os.path.exists(out)
    with pytest.raises(ValueError, match="unknown CRF backend"):
        tpost.check_backend("gpu")
