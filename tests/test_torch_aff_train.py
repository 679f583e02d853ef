"""The port's AffinityNet training against the JAX package's, on the CPU in
float32: the losses, the dataset and its loader, and one full-width step
against `jax.grad` + `poly_sgd` on a crop larger than its image. Inputs are
numpy-seeded; weights cross with `state_dict_from_jax`; each test states its
tolerance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import _nchw, random_jax_variables
from wseg_tpu.models import build_model as jax_build_model
from wseg_tpu.train import optim as jopt
from wseg_tpu.train.affinity import affinity_losses as jax_affinity_losses
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.layers import Dropout2d
from wseg_tpu_torch.ops.pairs import search_offsets
from wseg_tpu_torch.train import optim as topt
from wseg_tpu_torch.train.affinity import affinity_losses, make_aff_train_step
from wseg_tpu_torch.utils.checkpoint import state_dict_from_jax


def test_affinity_losses_match_jax():
    """Every loss and count within 1e-6 relative."""
    rng = np.random.RandomState(0)
    aff = rng.rand(2, 34, 40).astype(np.float32)
    labels = [(rng.rand(2, 34, 40) > t).astype(np.float32) for t in (0.7, 0.8, 0.6)]
    want = jax_affinity_losses(aff, *labels)
    got = affinity_losses(torch.from_numpy(aff), *map(torch.from_numpy, labels))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= 1e-6 * abs(float(want[k])), k


def make_aff_root(root, sizes, seed=0):
    """A VOC root of random JPEGs and low/high-alpha CRF score dirs (21, h, w);
    the first image's scores are saved in the reference's {class: map} dict
    form. Returns (voc root, list file, la dir, ha dir)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    voc = os.path.join(root, "VOC2012")
    os.makedirs(os.path.join(voc, "JPEGImages"))
    dirs = [os.path.join(root, "crf", a) for a in ("4.00", "24.00")]
    for d in dirs:
        os.makedirs(d)
    names = []
    for i, (h, w) in enumerate(sizes):
        name = f"2007_{i:06d}"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            os.path.join(voc, "JPEGImages", name + ".jpg"))
        for d in dirs:
            scores = rng.rand(21, h, w).astype(np.float32) * (rng.rand(21, 1, 1) > 0.6)
            scores[0, :, :w // 2] += 1.0  # background on the left half
            if i == 0:
                scores = {c: scores[c] for c in range(21)}
            np.save(os.path.join(d, name + ".npy"), scores)
        names.append(name)
    lst = os.path.join(root, "train.txt")
    with open(lst, "w") as f:
        f.write("".join(n + "\n" for n in names))
    return voc, lst, dirs[0], dirs[1]


SIZES = [(48, 40), (70, 90), (56, 64), (40, 100)]


def test_aff_dataset_and_loader_match_jax(tmp_path):
    """Same seed and epoch: bit-identical crops and targets, item by item
    and batch by batch (crop 64, so small images are padded)."""
    from wseg_tpu.data.loader import DataLoader as JaxLoader
    from wseg_tpu.data.voc12 import VOC12AffDataset as JaxDataset
    from wseg_tpu_torch.cli.aff_train import collate
    from wseg_tpu_torch.data.loader import DataLoader
    from wseg_tpu_torch.data.voc12 import VOC12AffDataset

    voc, lst, la, ha = make_aff_root(str(tmp_path), SIZES)
    want_ds = JaxDataset(lst, la, ha, voc, cropsize=64, det_seed=3)
    got_ds = VOC12AffDataset(lst, la, ha, voc, cropsize=64, det_seed=3)
    for epoch in (0, 2):
        want_ds.set_epoch(epoch)
        got_ds.set_epoch(epoch)
        for i in range(len(SIZES)):
            (ga, gl), (wa, wl) = got_ds[i], want_ds[i]
            assert ga.dtype == wa.dtype == np.float32
            np.testing.assert_array_equal(ga, wa)
            for a, b in zip(gl, wl):
                np.testing.assert_array_equal(a, b)

    def jax_collate(samples):
        return (np.stack([s[0] for s in samples]),
                *(np.stack([s[1][i] for s in samples]) for i in range(3)))

    loaders = [JaxLoader(want_ds, 2, shuffle=True, drop_last=True, num_workers=2,
                         collate=jax_collate, seed=3),
               DataLoader(got_ds, 2, num_workers=2, seed=3, collate=collate)]
    for epoch in (0, 1):
        batches = []
        for loader in loaders:
            loader.set_epoch(epoch)
            batches.append(list(loader))
        assert len(batches[0]) == len(batches[1]) == 2
        for bw, bg in zip(*batches):
            for a, b in zip(bg, bw):
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def one_step(tmp_path_factory):
    """One step of each package from the same weights on the same batch of 2
    crops of 64 from images smaller than the crop, dropout off."""
    from wseg_tpu.data.voc12 import VOC12AffDataset as JaxDataset

    voc, lst, la, ha = make_aff_root(str(tmp_path_factory.mktemp("aff")), [(48, 40), (40, 56)])
    ds = JaxDataset(lst, la, ha, voc, cropsize=64, det_seed=1)
    items = [ds[i] for i in range(2)]
    img = np.stack([it[0] for it in items])
    bg, fg, neg = (np.stack([it[1][k] for it in items]) for k in range(3))
    assert fg.sum() > 0 and neg.sum() > 0 and bg.sum() > 0

    jmodel = jax_build_model("affinity")
    variables = random_jax_variables(jmodel, (1, 64, 64, 3), seed=11)
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        mets = jax_affinity_losses(jmodel.apply({"params": p, "batch_stats": stats},
                                                jnp.asarray(img)), bg, fg, neg)
        return mets["loss"], mets

    (_, jmets), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    lr, wd, max_step = 0.01, 5e-4, 100
    tx = jopt.poly_sgd(lr, wd, max_step, labels=jopt.label_params(params))
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    model = build_model("affinity", device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.rate = 0.0
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = topt.PolySGD(topt.param_groups(model), lr, wd, max_step)
    mets = make_aff_train_step(model, opt)(_nchw(img), *map(torch.from_numpy, (bg, fg, neg)))
    with torch.no_grad():  # exact ties ft == ff in the step's pair features
        f = model.features(_nchw(img))
        ft_ff = [f[:, :, dy:dy + 6, 2 + dx:2 + dx + 4] - f[:, :, :6, 2:6]
                 for dy, dx in search_offsets(3)]  # the 8x8 map's radius-3 frames
        ties = int(sum(int((d == 0).sum()) for d in ft_ff))
    return dict(jmets=jmets, jgrads=jgrads, jnew=jnew, params=params, mets=mets, model=model,
                before=before, ties=ties)


def test_aff_train_step_losses_match_jax(one_step):
    """Losses within 1e-5 relative; the step's features hold exact ties, so
    the |ft - ff| gradient at 0 is exercised."""
    jmets, mets = one_step["jmets"], one_step["mets"]
    assert mets.keys() == jmets.keys()
    for k in jmets:
        assert abs(float(mets[k]) - float(jmets[k])) <= 1e-5 * abs(float(jmets[k])), k
    assert one_step["ties"] > 0


def _port_name(path):
    mods = path[1:-1] if path[0] == "backbone" else path[:-1]
    return ".".join(mods) + "." + {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]


def _hwio(t):
    t = t.detach()
    return t.permute(2, 3, 1, 0).numpy() if t.dim() == 4 else t.numpy()


def test_aff_train_step_parameters_match_jax(one_step):
    """Every updated parameter within 1e-4 relative of JAX's and every
    trained one's gradient within 1e-3 relative (of its largest entry); the
    frozen ones get no gradient and stay bit-unchanged on both sides."""
    named = dict(one_step["model"].named_parameters())
    labels = topt.label_params(one_step["model"])
    trained = 0
    for path, want in jax.tree_util.tree_leaves_with_path(one_step["jnew"]):
        keys = tuple(k.key for k in path)
        name = _port_name(keys)
        got, want = _hwio(named[name]), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), name
        if labels[name] == "frozen":
            assert named[name].grad is None
            np.testing.assert_array_equal(got, _hwio(one_step["before"][name]))
            np.testing.assert_array_equal(want, np.asarray(_tree_get(one_step["params"], keys)))
            continue
        want_g = np.asarray(_tree_get(one_step["jgrads"], keys))
        if np.abs(want_g).max() > 0:
            trained += 1
            assert _rel(_hwio(named[name].grad), want_g) <= 1e-3, name
    assert trained >= 10


def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())
