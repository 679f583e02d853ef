"""The port's accelerator CRF (wseg_tpu_torch/ops/crf.py) against the JAX
package's (wseg_tpu/ops/crf.py), on the CPU in float32, at a small size:
2-3 labels, t <= 3, images of at most 64x80 and 32-48 landmarks (the JAX side
takes seconds an image at full size on a CPU). The inputs are numpy-seeded;
each test states its tolerance and the largest error measured here.

The Nystrom inverse square root is never compared element-wise: on images
whose landmarks repeat colours, two float32 eigensolvers disagree on it, and
both are as far from float64 as from each other; the bilateral message and Q
do not inherit that difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wseg_tpu.ops import crf as jcrf
from wseg_tpu_torch.ops import crf as tcrf
from wseg_tpu_torch.ops.densecrf import crf_inference_labels

CPU = torch.device("cpu")


def _random_image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _flat_image(h, w):
    """Three flat colours in vertical bands, as sky and walls are."""
    img = np.zeros((h, w, 3), np.uint8)
    img[:, : w // 3] = (200, 30, 30)
    img[:, w // 3: 2 * w // 3] = (30, 200, 30)
    img[:, 2 * w // 3:] = (30, 30, 200)
    return img


def _scene(seed=0):
    """A 40x56 three-region image with 15% label noise."""
    h, w = 40, 56
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :20] = (40, 60, 200)
    img[:, 20:38] = (210, 180, 40)
    img[:, 38:] = (90, 200, 90)
    img = np.clip(img + np.random.RandomState(seed).randn(h, w, 3) * 6, 0, 255).astype(np.uint8)
    labels = np.zeros((h, w), np.uint8)
    labels[:, 20:38] = 1
    labels[:, 38:] = 2
    noisy = labels.copy()
    rng = np.random.RandomState(seed + 1)
    flip = rng.rand(h, w) < 0.15
    noisy[flip] = rng.randint(0, 3, flip.sum())
    return img, labels, noisy


@pytest.mark.parametrize("size,sigma", [(384, 80.0), (512, 32.0), (40, 3.0), (64, 13.0)])
def test_gauss_factors_bit_for_bit(size, sigma):
    """The numpy Gaussian matrix and its SVD factor equal the JAX package's
    bit for bit (the same numpy code)."""
    np.testing.assert_array_equal(tcrf._gauss_matrix_np(size, sigma),
                                  jcrf._gauss_matrix_np(size, sigma))
    for got, want in zip(tcrf._gauss_lowrank_np(size, sigma), jcrf._gauss_lowrank_np(size, sigma)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_gaussian_filter_matches_jax():
    """The exact spatial filter within 1e-5 of the output's max (measured
    0), with and without a leading alpha axis."""
    q = np.random.RandomState(0).rand(2, 37, 53, 3).astype(np.float32)
    want = np.stack([np.asarray(jcrf._gaussian_filter(jnp.asarray(x), 3.0)) for x in q])
    got = tcrf._gaussian_filter(torch.from_numpy(q), 3.0).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    single = tcrf._gaussian_filter(torch.from_numpy(q[0]), 3.0).numpy()
    np.testing.assert_array_equal(single, got[0])


@pytest.mark.parametrize("method", ["lowrank", "grid"])
@pytest.mark.parametrize("image", ["random", "flat"])
def test_bilateral_message_matches_jax(method, image):
    """One bilateral message of each method from the JAX package's factory
    and the port's on the same image, mask and values, at AdvCAM's sxy 80 /
    srgb 13 and 48 landmarks: within 1e-4 of its max (measured: lowrank
    2.6e-6 random, 7.6e-5 flat; grid 0 on both)."""
    h, w = 40, 56
    img = _random_image(h, w, 1) if image == "random" else _flat_image(h, w)
    v = np.random.RandomState(2).rand(h, w, 3).astype(np.float32)
    mask = np.ones((h, w, 1), np.float32)
    if method == "lowrank":
        args_j = ((h, w), 80.0, 13.0, 48, 1e-4)
        jfac, tfac = jcrf._lowrank_bilateral_factory, tcrf._lowrank_bilateral_factory
    else:
        args_j = ((h, w), 80.0, 13.0, 16)
        jfac, tfac = jcrf._grid_bilateral_factory, tcrf._grid_bilateral_factory
    want = np.asarray(jfac(*args_j, jnp.asarray(img), jnp.asarray(mask), (h, w), 16)(
        jnp.asarray(v)))
    got = tfac(*args_j, torch.from_numpy(img), torch.from_numpy(mask), (h, w), 16)(
        torch.from_numpy(v)).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("method", ["lowrank", "grid"])
def test_crf_labels_tpu_matches_jax(method):
    """The label-unary CRF (t 3, AdvCAM's parameters, 48 landmarks), padded
    to the 64 bucket: Q within 1e-4 (measured 1.2e-7 lowrank, 1.0e-9 grid)
    and the same argmax."""
    img, _, noisy = _scene()
    kw = dict(t=3, n_labels=3, n_landmarks=48, method=method, sxy_bilateral=80, srgb=13)
    want = jcrf.crf_labels_tpu(img, noisy, **kw)
    got = tcrf.crf_labels_tpu(img, noisy, device="cpu", **kw)
    assert got.shape == want.shape == (3, *noisy.shape) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(0), want.argmax(0))


def test_crf_labels_tpu_batch_matches_jax():
    """Three labellings of one image (the alpha sweep's batch, CAM
    parameters): Q within 1e-4 (measured 6.7e-7) and the same argmax."""
    img, _, noisy = _scene(3)
    labels = np.stack([noisy, (noisy + 1) % 3, np.zeros_like(noisy)]).astype(np.uint8)
    kw = dict(t=3, n_labels=3, n_landmarks=32, sxy_bilateral=50, srgb=5)
    want = jcrf.crf_labels_tpu_batch(img, labels, **kw)
    got = tcrf.crf_labels_tpu_batch(img, labels, device="cpu", **kw)
    assert got.shape == want.shape == (3, 3, *noisy.shape)
    assert np.abs(got - want).max() <= 1e-4
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def _probs(noisy, seed):
    rng = np.random.RandomState(seed)
    logits = np.eye(3, dtype=np.float32)[noisy] * 2.0 + rng.randn(*noisy.shape, 3) * 0.3
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return np.ascontiguousarray((e / e.sum(-1, keepdims=True)).transpose(2, 0, 1)
                                .astype(np.float32))


def test_crf_softmax_tpu_and_dense_crf_tpu_match_jax():
    """The softmax-unary CRF (t 3, 40 landmarks) and seg_test's one-iteration
    dense_crf_tpu (its 224 landmarks) on the same probabilities: Q within
    1e-4 (measured 1.1e-6 and 9.4e-6) and the same argmax."""
    img, _, noisy = _scene(5)
    probs = _probs(noisy, 6)
    kw = dict(t=3, n_labels=3, n_landmarks=40)
    pairs = [(jcrf.crf_softmax_tpu(img, probs, **kw),
              tcrf.crf_softmax_tpu(img, probs, device="cpu", **kw)),
             (jcrf.dense_crf_tpu(probs, img, n_classes=3),
              tcrf.dense_crf_tpu(probs, img, n_classes=3, device="cpu"))]
    for want, got in pairs:
        assert got.shape == want.shape == probs.shape
        assert np.abs(got - want).max() <= 1e-4
        np.testing.assert_array_equal(got.argmax(0), want.argmax(0))


PARAMS = dict(sxy_gaussian=3.0, compat_gaussian=3.0, sxy_bilateral=80.0, srgb=13.0,
              compat_bilateral=10.0)


@pytest.mark.parametrize("method,tol", [("lowrank", 2e-3), ("grid", 1e-5)])
def test_masked_bucket_padding_is_exact(method, tol):
    """A bucket-padded masked run's valid crop against the unpadded run
    (tests/test_crf_oracle.py's check of the JAX package, its tolerances):
    the same argmax; the grid within 1e-5, the lowrank within 2e-3 (only the
    padded size's SVD truncation differs). Measured 1.2e-7 and 0."""
    img, _, noisy = _scene()
    h, w = noisy.shape
    unary = torch.from_numpy(np.eye(3, dtype=np.float32)[noisy] * -1.5 + 1.0)
    hp, wp = h + 24, w + 40
    unary_p = torch.zeros(hp, wp, 3)
    unary_p[:h, :w] = unary
    img_p = torch.zeros(hp, wp, 3, dtype=torch.uint8)
    img_p[:h, :w] = torch.from_numpy(img)
    kw = dict(n_labels=3, t=10, method=method, device=CPU, n_landmarks=48, **PARAMS)
    want = tcrf.make_crf((h, w), **kw)(unary, torch.from_numpy(img))
    got = tcrf.make_crf((hp, wp), masked=True, **kw)(unary_p, img_p, (h, w))[:h, :w]
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert (got - want).abs().max().item() < tol


def test_batch_matches_single_alphas():
    """crf_labels_tpu_batch against one crf_labels_tpu call per labelling
    within 1e-5 (tests/test_crf_oracle.py's check of the JAX package): the
    same math, the landmark chunk's summation order aside (measured 0)."""
    img, _, noisy = _scene(7)
    labels = np.stack([noisy, ((noisy + 1) % 3).astype(np.uint8)])
    kw = dict(t=5, n_labels=3, n_landmarks=48, device="cpu")
    batch = tcrf.crf_labels_tpu_batch(img, labels, **kw)
    singles = np.stack([tcrf.crf_labels_tpu(img, lab, **kw) for lab in labels])
    np.testing.assert_allclose(batch, singles, rtol=0, atol=1e-5)


def test_denoises_and_agrees_with_native():
    """On a noisy three-region labelling the port's CRF cuts the label
    errors by more than 70% and agrees with the native CRF's argmax on more
    than 97% of the pixels (measured: 10.5% errors to 0, 100% agreement) (tests/test_crf_tpu.py's checks of the JAX
    package's)."""
    img, truth, noisy = _scene(9)
    got = tcrf.crf_labels_tpu(img, noisy, t=5, n_labels=3, device="cpu").argmax(0)
    native = crf_inference_labels(img, noisy, t=5, n_labels=3).argmax(0)
    assert (got != truth).mean() < 0.3 * (noisy != truth).mean()
    assert (got == native).mean() > 0.97


def test_make_crf_cache_is_keyed_by_device_and_guards_the_card():
    """One CRF per (parameters, device); the default device is the card, and
    without one every entry point raises before any work."""
    a = tcrf.make_crf((64, 64), n_labels=3, masked=True, device="cpu")
    assert tcrf.make_crf((64, 64), n_labels=3, masked=True, device=CPU) is a
    assert tcrf.make_crf((64, 64), n_labels=4, masked=True, device="cpu") is not a
    with pytest.raises(ValueError, match="unknown CRF method"):
        tcrf.make_crf((64, 64), method="lattice", device="cpu")
    if not torch.cuda.is_available():
        img, _, noisy = _scene()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcrf.crf_labels_tpu(img, noisy, n_labels=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcrf.dense_crf_tpu(_probs(noisy, 0), img, n_classes=3)


def test_seg_parameters_agreement_with_the_exact_crf():
    """At seg_test's CRF parameters (softmax unary, sxy 32, srgb 13, one
    iteration) on three 48x64 smooth synthetic images (`chip_smoke.py`'s
    `crf_inputs`, phase 19's inputs): the argmax agreement of the port's
    lowrank CRF with the exact dense CRF (tests/test_crf_oracle.py's float64
    oracle) equals the JAX package's within 0.5% (the port is faithful), and
    the native lattice's and the grid's are printed beside it. Measured:
    lowrank 0.9417-0.9508 (JAX the same), native 0.9759-0.9785, grid
    0.9788-0.9808."""
    from chip_smoke import crf_inputs
    from test_crf_oracle import dense_meanfield_oracle
    from wseg_tpu_torch.ops.densecrf import dense_crf

    rng = np.random.RandomState(19)
    for _ in range(3):
        img, _, _, probs = crf_inputs(rng, 48, 64)
        unary = -np.log(np.clip(probs.transpose(1, 2, 0), 1e-8, None))
        exact = dense_meanfield_oracle(img, unary, 1, 3.0, 3.0, 32.0, 13.0, 10.0).argmax(-1)
        got = (tcrf.dense_crf_tpu(probs, img, device="cpu").argmax(0) == exact).mean()
        want = (jcrf.dense_crf_tpu(probs, img).argmax(0) == exact).mean()
        grid = tcrf.crf_softmax_tpu(img, probs, t=1, method="grid", device="cpu",
                                    sxy_gaussian=3, compat_gaussian=3, sxy_bilateral=32,
                                    srgb=13, compat_bilateral=10).argmax(0)
        native = (dense_crf(probs, img).argmax(0) == exact).mean()
        print(f"agreement with the exact CRF: lowrank {got:.4f} (JAX {want:.4f}), "
              f"native {native:.4f}, grid {(grid == exact).mean():.4f}")
        assert abs(got - want) <= 0.005
