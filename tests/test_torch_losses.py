"""The port's stage-1 losses against the JAX package's on the same inputs.

Inputs are made with numpy from a seed, handed to `wseg_tpu` in NHWC and to
`wseg_tpu_torch` in NCHW, both in float32 on the CPU. Values and gradients
agree within 1e-5 relative (to the largest magnitude of the array), except
where a test says otherwise. Random draws are shared: `intra_view_nce`
takes the uniform keys that the JAX function draws from its key."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wseg_tpu.ops import losses as jl
from wseg_tpu.ops import topk as jt
from wseg_tpu.train.contrast import contrast_losses as jax_contrast_losses
from wseg_tpu_torch.ops import losses as tl
from wseg_tpu_torch.ops import topk as tt
from wseg_tpu_torch.train.contrast import contrast_losses

RTOL = 1e-5


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _tied_rows(seed, n=4, m=60):
    """Rows drawn from a few values: many ties, negatives, -0.0 and +0.0."""
    rng = np.random.RandomState(seed)
    vals = np.array([-2.5, -1.0, -0.0, 0.0, 0.5, 0.5, 1.25, 3.0], np.float32)
    x = vals[rng.randint(0, len(vals), size=(n, m))]
    return x + (rng.rand(n, m) < 0.3) * rng.randn(n, m).astype(np.float32)


def _torch_grad(fn, x_np, cot=None):
    x = torch.tensor(x_np, requires_grad=True)
    out = fn(x)
    out.backward(torch.from_numpy(cot) if cot is not None else None)
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("k", [1, 7, 30, 60])
def test_topk_sum_value_and_grad(k):
    x = _tied_rows(k)
    cot = np.random.RandomState(k + 1).randn(x.shape[0]).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jt.topk_sum(a, k), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(cot))
    got, got_g = _torch_grad(lambda a: tt.topk_sum(a, k), x, cot)
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got_g, want_g) <= RTOL


def test_topk_signed_zero_order():
    """-0.0 sorts below +0.0, as in the JAX package's uint32 order: with one
    +0.0 needed at the threshold, the -0.0 entries get no weight."""
    x = np.array([[-0.0, 0.0, 1.0, -0.0, 0.0, -1.0]], np.float32)
    _, vjp = jax.vjp(lambda a: jt.topk_sum(a, 2), jnp.asarray(x))
    (want_g,) = vjp(jnp.ones(1, jnp.float32))
    _, got_g = _torch_grad(lambda a: tt.topk_sum(a, 2).sum(), x)
    np.testing.assert_array_equal(got_g, np.asarray(want_g))
    np.testing.assert_array_equal(got_g, [[0.0, 0.5, 1.0, 0.0, 0.5, 0.0]])


@pytest.mark.parametrize("k", [5, 33])
def test_topk_mean_and_bottomk_relu_sum(k):
    x = _tied_rows(100 + k)
    for jf, tf in [(jt.topk_mean, tt.topk_mean), (jt.bottomk_relu_sum, tt.bottomk_relu_sum),
                   (jl.topk_mean, tl.topk_mean)]:
        want, want_g = jax.value_and_grad(lambda a: jf(a, k))(jnp.asarray(x))
        got, got_g = _torch_grad(lambda a: tf(a, k), x)
        assert _rel_err(got, want) <= RTOL, jf
        assert _rel_err(got_g, want_g) <= RTOL, jf


def test_multilabel_soft_margin_loss():
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 20).astype(np.float32) * 3
    targets = (rng.rand(4, 20) > 0.7).astype(np.float32)
    want = jl.multilabel_soft_margin_loss(jnp.asarray(logits), jnp.asarray(targets))
    got = tl.multilabel_soft_margin_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    assert _rel_err(got.numpy(), want) <= RTOL


def test_adaptive_min_pooling_loss():
    x = np.random.RandomState(1).randn(2, 12, 10, 20).astype(np.float32)
    x[:, :, :, 5:] = 0.0  # unlabeled channels tie at 0, as (cam_rv * lbl) does
    want, want_g = jax.value_and_grad(jl.adaptive_min_pooling_loss)(jnp.asarray(x))
    got, got_g = _torch_grad(tl.adaptive_min_pooling_loss, _nchw(x).numpy())
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got_g.transpose(0, 2, 3, 1), want_g) <= RTOL


def test_ecr_loss():
    rng = np.random.RandomState(2)
    other = rng.rand(2, 16, 16, 21).astype(np.float32)
    other[..., 3:] = 0.0
    cam_rv = rng.rand(2, 16, 16, 21).astype(np.float32)
    want, want_g = jax.value_and_grad(jl.ecr_loss, argnums=1)(jnp.asarray(other),
                                                              jnp.asarray(cam_rv))
    got, got_g = _torch_grad(lambda c: tl.ecr_loss(_nchw(other), c), _nchw(cam_rv).numpy())
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got_g.transpose(0, 2, 3, 1), want_g) <= RTOL


def test_normalize_cam_for_prototypes():
    cam = np.random.RandomState(3).randn(2, 8, 8, 21).astype(np.float32)
    want = jl.normalize_cam_for_prototypes(jnp.asarray(cam), 0.2)
    got = tl.normalize_cam_for_prototypes(_nchw(cam), 0.2)
    assert _rel_err(_nhwc(got), want) <= RTOL


def test_estimate_prototypes_constant_bg_channel():
    """The bg channel is `bg_threshold` everywhere: its top-k is all ties, and
    the port keeps the lower indices first as jax.lax.top_k does, with no
    pinning of the choice."""
    rng = np.random.RandomState(4)
    fea = rng.rand(2, 8, 8, 128).astype(np.float32)
    norm_cam = np.asarray(jl.normalize_cam_for_prototypes(
        jnp.asarray(rng.randn(2, 8, 8, 21).astype(np.float32)), 0.2))
    label = np.zeros((2, 21), np.float32)
    label[:, 0] = 1
    label[0, [3, 9]] = 1
    label[1, 12] = 1
    assert np.all(norm_cam[..., 0] == np.float32(0.2))
    want_p, want_pl = jl.estimate_prototypes(jnp.asarray(fea), jnp.asarray(norm_cam),
                                             jnp.asarray(label))
    got_p, got_pl = tl.estimate_prototypes(_nchw(fea), _nchw(norm_cam), torch.from_numpy(label))
    np.testing.assert_array_equal(got_pl.numpy(), np.asarray(want_pl))
    assert _rel_err(got_p.numpy(), want_p) <= RTOL
    # bg prototype: the mean of the first h*w//8 pixels' features, normalized
    bg = fea.reshape(-1, 128)[:8].mean(axis=0)
    np.testing.assert_allclose(got_p[0].numpy(), bg / np.linalg.norm(bg), rtol=1e-5)


def test_info_nce():
    rng = np.random.RandomState(5)
    f = rng.randn(50, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    negs = rng.randn(21, 16).astype(np.float32)
    negs /= np.linalg.norm(negs, axis=1, keepdims=True)
    pos = negs[rng.randint(0, 21, 50)]
    want, want_g = jax.value_and_grad(jl.info_nce)(jnp.asarray(f), jnp.asarray(pos),
                                                   jnp.asarray(negs))
    got, got_g = _torch_grad(
        lambda a: tl.info_nce(a, torch.from_numpy(pos), torch.from_numpy(negs)), f)
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got_g, want_g) <= RTOL


def test_intra_view_nce_same_keys():
    rng = np.random.RandomState(6)
    m = 128
    f = rng.randn(m, 16).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    protos = rng.randn(21, 16).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    pl = rng.choice([0, 2, 5, 7, 11], size=m).astype(np.int32)
    pl[:1] = 19  # a class with one member: present, but no loss
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, (m,)))
    want, want_g = jax.value_and_grad(jl.intra_view_nce)(
        jnp.asarray(f), jnp.asarray(protos), jnp.asarray(pl), key)
    got, got_g = _torch_grad(lambda a: tl.intra_view_nce(
        a, torch.from_numpy(protos), torch.from_numpy(pl).long(), torch.from_numpy(u)), f)
    assert _rel_err(got, want) <= RTOL
    assert _rel_err(got_g, want_g) <= RTOL


def _random_outputs(rng, n, size, cf=128):
    """(cam, cam_rv, f_proj, cam_rv_down) NHWC at input size `size`."""
    s8 = size // 8
    return (rng.randn(n, size, size, 21).astype(np.float32),
            rng.randn(n, size, size, 21).astype(np.float32),
            np.maximum(rng.randn(n, s8, s8, cf), 0).astype(np.float32),
            rng.randn(n, s8, s8, 21).astype(np.float32))


def test_contrast_losses_match_jax():
    """Every loss term, and its gradient with respect to each model output,
    on the same random outputs of the two views (crop 64, low_res 32)."""
    rng = np.random.RandomState(8)
    n, hi, low = 2, 64, 32
    out1, out2 = _random_outputs(rng, n, hi), _random_outputs(rng, n, low)
    label = np.zeros((n, 21), np.float32)
    label[:, 0] = 1
    label[0, 3] = label[1, 7] = label[1, 12] = 1
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    m = n * (low // 8) ** 2
    us = (np.array(jax.random.uniform(k1, (m,))), np.array(jax.random.uniform(k2, (m,))))

    def jax_loss(o1, o2):
        mets = jax_contrast_losses(o1, o2, jnp.asarray(label), (k1, k2), 0.2, low_res=low)
        return mets["loss"], mets

    (_, want), (want_g1, want_g2) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        tuple(map(jnp.asarray, out1)), tuple(map(jnp.asarray, out2)))
    t1 = tuple(_nchw(o).requires_grad_() for o in out1)
    t2 = tuple(_nchw(o).requires_grad_() for o in out2)
    got = contrast_losses(t1, t2, torch.from_numpy(label),
                          tuple(torch.from_numpy(u) for u in us), 0.2, low_res=low)
    assert got.keys() == want.keys()
    for key in want:
        assert _rel_err(got[key].detach().numpy(), want[key]) <= RTOL, key
    got["loss"].backward()
    for name, t, g in zip(["cam", "cam_rv", "f_proj", "cam_rv_down"] * 2, t1 + t2,
                          tuple(want_g1) + tuple(want_g2)):
        if t.grad is None:  # used only detached: JAX's gradient is zero
            assert not np.any(np.asarray(g)), name
        else:
            assert _rel_err(_nhwc(t.grad), g) <= RTOL, name
