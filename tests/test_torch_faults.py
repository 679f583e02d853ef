"""Faults the port had against the JAX package, each held by a CPU test
against the JAX function it must match:

* batch-statistics BN at one value per channel (ASPP's global branch at
  batch 1), against wseg_tpu/models/layers.py:BatchNorm2d;
* the data loader's `shuffle=False` order, against wseg_tpu/data/loader.py;
* the ImageNet MXNet `.params` reader, against
  wseg_tpu/utils/checkpoint.py:convert_mxnet_params, and contrast_train
  starting from a trunk-only file, as the JAX CLI's merge_params lets it.
"""

import io
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _make_voc
from test_torch_models import drop_tmp_path  # noqa: F401 (an autouse fixture)
from wseg_tpu.models.layers import BatchNorm2d as JaxBatchNorm2d
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.layers import BatchNorm2d
from wseg_tpu_torch.utils.checkpoint import (
    STAGE1_HEADS, load_weights, merge_state_dict,
)


def test_batch_norm_one_value_per_channel_matches_jax():
    """Train-mode BN on a (1, C, 1, 1) input: the output and both running
    stats equal the JAX package's within 1e-7 (the variance update is var *
    n / max(n - 1, 1) at n = 1), and the output is the bias up to the
    rounding of x * weight / sqrt(eps), ~300 x (measured 1.5e-5)."""
    c, mom = 6, 0.1
    rng = np.random.RandomState(0)
    x = rng.randn(1, c, 1, 1).astype(np.float32)
    gamma, beta = rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)
    mean0, var0 = rng.randn(c).astype(np.float32), rng.rand(c).astype(np.float32) + 0.5

    jbn = JaxBatchNorm2d(c, momentum=mom, frozen=False)
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, upd = jbn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                          use_running_average=False, mutable=["batch_stats"])

    bn = BatchNorm2d(c, frozen=False, momentum=mom).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_()
    got = bn(xt)
    got.sum().backward()  # differentiable, as a training step needs
    assert xt.grad is not None and bool(torch.isfinite(xt.grad).all())
    got = got.detach().numpy()
    np.testing.assert_allclose(got[:, :, 0, 0], beta[None], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=0, atol=1e-7)


def test_aspp_global_branch_trains_at_batch_one():
    """One seg_train step of EPS_deeplabv2_resnet101's head (ASPP with its
    global branch) on a resnet18 backbone at batch 1 runs and is finite,
    and moves the global branch's BN stats."""
    from wseg_tpu_torch.seg.config import EXPERIMENTS
    from wseg_tpu_torch.seg.deeplab import generate_net
    from wseg_tpu_torch.train.optim import PolySGD, param_groups, seg_label_params
    from wseg_tpu_torch.train.seg import make_seg_train_step

    cfg = EXPERIMENTS["EPS_deeplabv2_resnet101"].replace(MODEL_BACKBONE="resnet18",
                                                         MODEL_ASPP_OUTDIM=32)
    model = generate_net(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = model.aspp.branch5_bn.running_var.clone()
    opt = PolySGD(param_groups(model, seg_label_params(model)), 1e-3, 5e-4, 10, momentum=0.9)
    step = make_seg_train_step(model, opt, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(1, 3, 48, 48, generator=gen)
    lab = torch.randint(0, 21, (1, 48, 48), generator=gen)
    mets = step(img, lab)
    assert np.isfinite(float(mets["loss"]))
    assert all(bool(torch.isfinite(v).all()) for v in model.state_dict().values())
    assert not torch.equal(model.aspp.branch5_bn.running_var, before)


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full(2, i, np.int32),)


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_order_matches_jax(shuffle):
    """Batch for batch the JAX package's order: the list's with
    shuffle=False, the same seeded permutation with shuffle=True."""
    from wseg_tpu.data.loader import DataLoader as JaxLoader
    from wseg_tpu_torch.data.loader import DataLoader

    def order(loader):
        loader.set_epoch(2)
        return [b[0][:, 0].tolist() for b in loader]

    got = order(DataLoader(_Items(11), 3, num_workers=2, seed=4, shuffle=shuffle))
    want = order(JaxLoader(_Items(11), 3, shuffle=shuffle, num_workers=2, seed=4,
                           collate=lambda s: (np.stack([x[0] for x in s]),)))
    assert got == want
    assert (got == [[0, 1, 2], [3, 4, 5], [6, 7, 8]]) == (not shuffle)


def _mx_record(a: np.ndarray, version: str) -> bytes:
    """One NDArray record in each of the reader's formats."""
    if version == "v2":
        head = struct.pack("<Ii", 0xF993FAC9, 0) + struct.pack("<I", a.ndim)
        head += b"".join(struct.pack("<I", d) for d in a.shape)
    elif version == "v3":
        head = struct.pack("<Ii", 0xF993FACA, 0) + struct.pack("<I", a.ndim)
        head += b"".join(struct.pack("<q", d) for d in a.shape)
    else:  # legacy: no magic
        head = struct.pack("<I", a.ndim) + b"".join(struct.pack("<I", d) for d in a.shape)
    return head + struct.pack("<iii", 1, 0, 0) + a.astype("<f4").tobytes()


def _write_params(path, arrays: dict):
    buf = io.BytesIO()
    buf.write(struct.pack("<QQQ", 0x112, 0, len(arrays)))
    versions = ["v2", "v3", "legacy"]
    for i, a in enumerate(arrays.values()):
        buf.write(_mx_record(a, versions[i % 3]))
    buf.write(struct.pack("<Q", len(arrays)))
    for name in arrays:
        buf.write(struct.pack("<Q", len(name)) + name.encode())
    with open(path, "wb") as f:
        f.write(buf.getvalue())


@pytest.fixture(scope="module")
def params_file(tmp_path_factory):
    """A synthetic ImageNet `.params` of the contrast trunk's shapes: the
    stem, a b2 unit (conv and all four BN leaves), a b4 unit past the
    first, bn7, and the classifier the reader drops."""
    sd = build_model("contrast", device="cpu").state_dict()
    rng = np.random.RandomState(3)

    def like(key):
        return rng.randn(*sd[key].shape).astype(np.float32)

    arrays = {
        "arg:conv1a_weight": like("conv1a.weight"),
        "arg:res2a_branch2a_weight": like("b2.conv_branch2a.weight"),
        "arg:bn2a_branch2a_gamma": like("b2.bn_branch2a.weight"),
        "arg:bn2a_branch2a_beta": like("b2.bn_branch2a.bias"),
        "aux:bn2a_branch2a_moving_mean": like("b2.bn_branch2a.running_mean"),
        "aux:bn2a_branch2a_moving_var": np.abs(like("b2.bn_branch2a.running_var")) + 0.5,
        "arg:res4b1_branch2b1_weight": like("b4_1.conv_branch2b1.weight"),
        "arg:bn7_gamma": like("bn7.weight"),
        "aux:bn7_moving_var": np.abs(like("bn7.running_var")) + 0.5,
        "arg:linear1000_weight": rng.randn(10, 8).astype(np.float32),
    }
    path = str(tmp_path_factory.mktemp("params") / "ilsvrc.params")
    _write_params(path, arrays)
    return path


def test_params_reader_equals_jax_bit_for_bit(params_file):
    """The port's `.params` state_dict equals the JAX package's
    convert_mxnet_params carried through state_dict_from_jax, key for key
    and bit for bit; the classifier is dropped and every key is the
    contrast net's at its shape."""
    from wseg_tpu.utils.checkpoint import convert_mxnet_params
    from wseg_tpu_torch.utils.checkpoint import state_dict_from_jax

    got = load_weights(params_file)
    want = state_dict_from_jax(*convert_mxnet_params(params_file))
    assert got.keys() == want.keys() and len(got) == 9
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    sd = build_model("contrast", device="cpu").state_dict()
    assert all(got[k].shape == sd[k].shape for k in got)


def test_merged_heads_keep_their_init(tmp_path):
    """A trunk-only file merged over the seeded init: the trunk entries are
    the file's, the stage-1 heads keep their init."""
    init = build_model("contrast", device="cpu", generator=torch.Generator().manual_seed(1))
    other = build_model("contrast", device="cpu", generator=torch.Generator().manual_seed(2))
    trunk = {k: v for k, v in other.state_dict().items() if k.split(".")[0] not in STAGE1_HEADS}
    merged = merge_state_dict(init.state_dict(), trunk, what="pretrained weights")
    assert merged.keys() == init.state_dict().keys()
    for k, v in merged.items():
        src = init.state_dict() if k.split(".")[0] in STAGE1_HEADS else trunk
        assert torch.equal(v, src[k]), k


@pytest.mark.parametrize("kind", ["pth", "params"])
def test_contrast_train_starts_from_a_trunk_only_file(tmp_path, params_file, kind, capsys):
    """One contrast_train step on the CPU from a trunk-only `.pth` (what the
    reference's convert_mxnet_to_torch writes) and from the `.params`: the
    CLI merges them, and the frozen stem keeps the file's values."""
    from wseg_tpu_torch.cli import contrast_train

    if kind == "pth":
        sd = build_model("contrast", device="cpu",
                         generator=torch.Generator().manual_seed(9)).state_dict()
        weights = str(tmp_path / "trunk.pth")
        torch.save({k: v for k, v in sd.items() if k.split(".")[0] not in STAGE1_HEADS},
                   weights)
    else:
        weights = params_file
    root, train_list = _make_voc(str(tmp_path / "VOC2012"), n=2)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        contrast_train.main([
            "--device", "cpu", "--train_list", train_list, "--voc12_root", root,
            "--batch_size", "2", "--crop_size", "48", "--low_res", "32", "--min_long", "48",
            "--max_long", "80", "--num_workers", "2", "--tblog_dir", str(tmp_path / "tb"),
            "--grad_clip", "5.0", "--max_epoches", "1", "--weights", weights])
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert "merged" in out and f"pretrained weights from {weights}" in out
    final = load_weights(str(tmp_path / "result" / "resnet38" / contrast_train.WEIGHTS))
    assert torch.equal(final["conv1a.weight"], load_weights(weights)["conv1a.weight"])
    assert all(bool(torch.isfinite(v).all()) for v in final.values())
    # the run's stdout is teed to result/<session>/contrast.log
    log = (tmp_path / "result" / "resnet38" / "contrast.log").read_text()
    assert f"pretrained weights from {weights}" in log
