"""The port's stage-1 training against the JAX package's, on the CPU in
float32: the optimizers, the parameter groups, one full-width dual-view step,
the input pipeline, the training CLI with a kill and a resume, and the
checkpoint writer. Inputs are made with numpy from a seed; weights cross
with `state_dict_from_jax`; the random draws of the intra-view NCE are the
ones the JAX step makes from its keys. Each test states its tolerance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_models import (  # noqa: F401 (drop_tmp_path: an autouse fixture)
    _nchw, _rel_err, port_model_from_jax, random_jax_variables, drop_tmp_path,
)
from wseg_tpu.models import build_model as jax_build_model
from wseg_tpu.train import optim as jopt
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.layers import Dropout2d
from wseg_tpu_torch.train import optim as topt
from wseg_tpu_torch.train.contrast import make_train_step
from wseg_tpu_torch.utils.checkpoint import load_weights, save_weights

# gradient targets of tests/test_gradient_parity.py: (port name, JAX path)
GRAD_TARGETS = [
    ("fc8.weight", ("fc8", "kernel")),
    ("fc_proj.weight", ("fc_proj", "kernel")),
    ("f9.weight", ("f9", "kernel")),
    ("f8_3.weight", ("f8_3", "kernel")),
    ("f8_4.weight", ("f8_4", "kernel")),
    ("b7.conv_branch2a.weight", ("backbone", "b7", "conv_branch2a", "kernel")),
    ("b3.conv_branch2a.weight", ("backbone", "b3", "conv_branch2a", "kernel")),
    ("b4_2.conv_branch2b1.weight", ("backbone", "b4_2", "conv_branch2b1", "kernel")),
]
FROZEN = [("conv1a.weight", ("backbone", "conv1a", "kernel")),
          ("b2.conv_branch2a.weight", ("backbone", "b2", "conv_branch2a", "kernel")),
          ("b5.bn_branch2a.weight", ("backbone", "b5", "bn_branch2a", "scale"))]


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_name(path):
    """JAX param path -> the port's parameter name (utils/checkpoint.py naming)."""
    mods = path[1:-1] if path[0] == "backbone" else path[:-1]
    return ".".join(mods) + "." + {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]


def _hwio(t):
    return t.detach().permute(2, 3, 1, 0).numpy() if t.dim() == 4 else t.detach().numpy()


class _Leaf(nn.Module):
    def __init__(self, rng, shape, bias=False, bn=False):
        super().__init__()
        self.weight = nn.Parameter(torch.from_numpy(rng.randn(*shape).astype(np.float32)))
        if bias or bn:
            self.bias = nn.Parameter(torch.from_numpy(rng.randn(shape[-1]).astype(np.float32)))


def _toy_model():
    """One parameter of each group, named as in the contrast net."""
    rng = np.random.RandomState(0)
    model = nn.Module()
    model.conv1a = _Leaf(rng, (3, 4))                 # frozen
    model.b3 = nn.Module()
    model.b3.conv_branch2a = _Leaf(rng, (4, 5))       # pretrained_w
    model.b3.bn_branch2a = _Leaf(rng, (5,), bn=True)  # frozen BN affine
    model.b4 = nn.Module()
    model.b4.conv_x = _Leaf(rng, (5, 6), bias=True)   # pretrained_w, pretrained_b
    model.fc8 = _Leaf(rng, (6, 7), bias=True)         # scratch_w, scratch_b
    return model


def _jax_tree(named):
    """(port name, array) pairs -> the JAX params tree of the same leaves."""
    tree = {}
    for name, a in named:
        *mods, leaf = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        is_bn = mods[-1].startswith("bn")
        node[{"weight": "scale" if is_bn else "kernel", "bias": "bias"}[leaf]] = jnp.asarray(a)
    return tree


def _params_tree(model):
    return _jax_tree((n, p.detach().numpy().copy()) for n, p in model.named_parameters())


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_poly_optimizers_match_jax(kind):
    """3 steps on the same gradients; parameters within 1e-5 relative, the
    frozen ones unchanged on both sides."""
    model = _toy_model()
    params = _params_tree(model)
    labels = jopt.label_params(params)
    lr, wd, max_step = 0.1, 5e-4, 10
    if kind == "sgd":
        tx = jopt.poly_sgd(lr, wd, max_step, momentum=0.9, labels=labels)
        opt = topt.PolySGD(topt.param_groups(model), lr, wd, max_step, momentum=0.9)
    else:
        tx = jopt.poly_adam(lr, wd, max_step, labels=labels)
        opt = topt.PolyAdam(topt.param_groups(model), lr, wd, max_step)
    state = tx.init(params)
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32) for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
        updates, state = tx.update(_jax_tree(grads.items()), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    got = _params_tree(model)
    for (path, a), (_, ref) in zip(jax.tree_util.tree_leaves_with_path(got),
                                   jax.tree_util.tree_leaves_with_path(params)):
        assert _rel_err(np.asarray(a), np.asarray(ref)) <= 1e-5, path
    np.testing.assert_array_equal(model.conv1a.weight.detach().numpy(),
                                  np.random.RandomState(0).randn(3, 4).astype(np.float32))
    assert opt.step_count == 3


def test_label_params_match_jax_on_contrast_net():
    jmodel = jax_build_model("contrast")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    jlabels = jopt.label_params(shapes["params"])
    want = {_port_name(tuple(k.key for k in path)): lbl
            for path, lbl in jax.tree_util.tree_leaves_with_path(jlabels)}
    got = topt.label_params(build_model("contrast", device="cpu"))
    assert got == want
    assert {"frozen", "pretrained_w", "scratch_w"} <= set(got.values())


def _disable_dropout(model):
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.rate = 0.0


@pytest.fixture(scope="module")
def one_step():
    """One full-width dual-view step (crop 64, low_res 32, batch 2, dropout
    off, the same intra-view keys) in both packages, from the same weights."""
    from wseg_tpu.ops.resize import resize_bilinear
    from wseg_tpu.train.contrast import contrast_losses

    jmodel = jax_build_model("contrast", fused_pcm=False)
    variables = random_jax_variables(jmodel, (1, 64, 64, 3), seed=3)
    params, stats = variables["params"], variables["batch_stats"]
    n, hi, low = 2, 64, 32
    rng = np.random.RandomState(21)
    img = rng.randn(n, hi, hi, 3).astype(np.float32) * 0.5
    label = np.zeros((n, 20), np.float32)
    label[0, 2] = label[1, 6] = label[1, 11] = 1
    label21 = np.concatenate([np.ones((n, 1), np.float32), label], axis=1)
    k1, k2 = jax.random.split(jax.random.PRNGKey(4))
    m = n * (low // 8) ** 2
    us = (np.array(jax.random.uniform(k1, (m,))), np.array(jax.random.uniform(k2, (m,))))

    x1 = jnp.asarray(img)
    x2 = resize_bilinear(x1, (low, low), align_corners=True)

    def loss_fn(p):
        vs = {"params": p, "batch_stats": stats}
        mets = contrast_losses(jmodel.apply(vs, x1), jmodel.apply(vs, x2),
                               jnp.asarray(label21), (k1, k2), 0.2, low_res=low)
        return mets["loss"], mets

    (_, jmets), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    lr, wd, max_step = 0.01, 5e-4, 100
    tx = jopt.poly_sgd(lr, wd, max_step, labels=jopt.label_params(params))
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    model = port_model_from_jax(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _disable_dropout(model)
    opt = topt.PolySGD(topt.param_groups(model), lr, wd, max_step)
    step = make_train_step(model, opt, 0.2, low_res=low)
    mets = step(_nchw(img), torch.from_numpy(label), us=tuple(map(torch.from_numpy, us)))
    return dict(jmets=jmets, jgrads=jgrads, jnew=jnew, params=params, mets=mets,
                model=model, before=before)


def test_train_step_losses_match_jax(one_step):
    """Every loss term within 1e-4 relative."""
    jmets, mets = one_step["jmets"], one_step["mets"]
    assert mets.keys() == jmets.keys()
    for key in jmets:
        assert abs(float(mets[key]) - float(jmets[key])) <= 1e-4 * abs(float(jmets[key])), key


def test_train_step_gradients_and_update_match_jax(one_step):
    """The gradient targets of tests/test_gradient_parity.py and their updated
    values within 1e-3 relative; frozen parameters bit-unchanged."""
    named = dict(one_step["model"].named_parameters())
    for name, path in GRAD_TARGETS:
        want_g = np.asarray(_tree_get(one_step["jgrads"], path))
        assert np.abs(want_g).max() > 0, name
        assert _rel_err(_hwio(named[name].grad), want_g) <= 1e-3, name
        assert _rel_err(_hwio(named[name]), np.asarray(_tree_get(one_step["jnew"], path))) <= 1e-3
        assert not torch.equal(named[name], one_step["before"][name]), name
    for name, path in FROZEN:
        torch.testing.assert_close(named[name].detach(), one_step["before"][name], rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(_tree_get(one_step["jnew"], path)),
                                      np.asarray(_tree_get(one_step["params"], path)))


def test_mixed_precision_step_close_to_f32():
    """bf16 forward and backward against the f32 step from the same weights:
    the total loss within 5% (the JAX package's own bound for its bf16 step),
    finite, and the master parameters stay float32."""
    img = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 64, 64).astype(np.float32))
    label = torch.zeros(2, 20)
    label[0, 3] = label[1, 7] = 1
    losses = {}
    for dtype in (None, torch.bfloat16):
        model = build_model("contrast", device="cpu", generator=torch.Generator().manual_seed(0))
        _disable_dropout(model)
        opt = topt.PolySGD(topt.param_groups(model), 0.01, 5e-4, 100)
        mets = make_train_step(model, opt, low_res=32, compute_dtype=dtype)(img, label)
        assert all(bool(torch.isfinite(v)) for v in mets.values())
        assert model.fc8.weight.dtype == torch.float32
        losses[dtype] = float(mets["loss"])
    assert abs(losses[torch.bfloat16] - losses[None]) <= 0.05 * abs(losses[None]), losses


def _make_voc(root, n=4, size=(72, 56), seed=0):
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "Annotations"))
    cats = ["dog", "cat", "person", "car"]
    names = []
    for i in range(n):
        name = f"2007_{i:06d}"
        arr = (rng.rand(size[1] + 8 * i, size[0], 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, "JPEGImages", name + ".jpg"))
        with open(os.path.join(root, "Annotations", name + ".xml"), "w") as f:
            f.write(f"<annotation><object><name>{cats[i % 4]}</name></object></annotation>")
        names.append(name)
    train_list = os.path.join(os.path.dirname(root), "train.txt")
    with open(train_list, "w") as f:
        f.write("".join(n + "\n" for n in names))
    return root, train_list


def test_contrast_dataset_and_loader_match_jax(tmp_path):
    """Same seed and epoch: the same shuffle and bit-identical augmented crops."""
    from wseg_tpu.data.loader import DataLoader as JaxLoader
    from wseg_tpu.data.voc12 import ContrastTrainDataset as JaxDataset
    from wseg_tpu_torch.data.loader import DataLoader
    from wseg_tpu_torch.data.voc12 import ContrastTrainDataset

    root, train_list = _make_voc(str(tmp_path / "VOC2012"))
    kw = dict(crop_size=48, min_long=48, max_long=96, det_seed=5)
    loaders = [L(D(train_list, root, **kw), 2, num_workers=2, seed=5)
               for L, D in ((JaxLoader, JaxDataset), (DataLoader, ContrastTrainDataset))]
    for epoch in (0, 3):
        batches = []
        for loader in loaders:
            loader.set_epoch(epoch)
            batches.append(list(loader))
        for (jn, jimg, jlab), (tn, timg, tlab) in zip(*batches):
            assert jn == tn
            np.testing.assert_array_equal(timg, jimg)
            np.testing.assert_array_equal(tlab, jlab)


def _train(tmp_path, root, train_list, session, extra):
    from wseg_tpu_torch.cli import contrast_train

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        contrast_train.main([
            "--device", "cpu", "--train_list", train_list, "--voc12_root", root,
            "--batch_size", "2", "--crop_size", "48", "--low_res", "32",
            "--min_long", "48", "--max_long", "80", "--num_workers", "2",
            "--session_name", session, "--tblog_dir", str(tmp_path / "tblog" / session),
            "--grad_clip", "5.0", "--max_epoches", "2"] + extra)
    finally:
        os.chdir(cwd)
    return tmp_path / "result" / session


def test_cli_kill_and_resume_equals_uninterrupted(tmp_path):
    """2 epochs in one run against 1 epoch, a kill, and a resume from the
    epoch's train state: the final weights are bit-identical. The final
    file has the reference's keys: the port's and the JAX package's loaders
    both read it."""
    from wseg_tpu.utils.checkpoint import load_pretrained

    root, train_list = _make_voc(str(tmp_path / "VOC2012"))
    full = _train(tmp_path, root, train_list, "full", [])
    part = _train(tmp_path, root, train_list, "part",
                  ["--save_every_epoch", "--stop_after_epoch", "1"])
    assert (part / "contrast_train.pth").exists() and not (part / "contrast.pth").exists()
    with pytest.raises(SystemExit):  # --start_epoch without --resume
        _train(tmp_path, root, train_list, "part", ["--start_epoch", "1"])
    with pytest.raises(SystemExit):  # a train state saved after epoch 0 resumed as epoch 0
        _train(tmp_path, root, train_list, "part",
               ["--resume", str(part / "contrast_train.pth"), "--start_epoch", "0"])
    _train(tmp_path, root, train_list, "part",
           ["--resume", str(part / "contrast_train.pth"), "--start_epoch", "1"])

    want = load_weights(str(full / "contrast.pth"))
    got = load_weights(str(part / "contrast.pth"))
    assert want.keys() == got.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    init = build_model("contrast", device="cpu", generator=torch.Generator().manual_seed(1))
    assert not torch.equal(want["fc8.weight"], init.fc8.weight.detach())
    init.load_state_dict(want, strict=True)
    params, stats = load_pretrained(str(full / "contrast.pth"))
    np.testing.assert_array_equal(np.asarray(params["fc8"]["kernel"]), _hwio(want["fc8.weight"]))
    with pytest.raises(ValueError):
        load_weights(str(part / "contrast_train.pth"))


def test_checkpoint_writer_removes_stale_temps(tmp_path):
    model = nn.Linear(3, 2)
    path = tmp_path / "w.pth"
    stale = [tmp_path / ".w.pth.tmp.12345", tmp_path / ".w.pth.tmp.7"]
    for s in stale:
        s.write_bytes(b"partial")
    other = tmp_path / ".v.pth.tmp.1"
    other.write_bytes(b"someone else's")
    save_weights(str(path), model)
    assert not any(s.exists() for s in stale) and other.exists()
    assert sorted(p.name for p in tmp_path.iterdir()) == [".v.pth.tmp.1", "w.pth"]
    torch.testing.assert_close(torch.load(path)["weight"], model.weight.detach())
