"""Stage 3 of the port from its command lines, on the CPU, on a synthetic VOC
seg root: seg_train (2 epochs; then a kill after epoch 1 and a resume), then
seg_test (6 scales x flip) with the native CRF and without, from the port's
`.pth` and from a JAX `.ckpt` of the same weights. Weights are random from a
seed. The CLIs run an experiment added to the presets for the test, DeepLab
v2 with the global ASPP branch on ResNet-18: the presets' nets write 0.5-1
GB a checkpoint, and their code is held by tests/test_torch_seg_models.py."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_seg_dataset import make_seg_root
from wseg_tpu_torch.seg.config import EXPERIMENTS, SegConfig
from wseg_tpu_torch.seg.deeplab import generate_net
from wseg_tpu_torch.utils.checkpoint import load_weights

SIZES = [(36, 44), (40, 28), (32, 32), (24, 40)]
EXP = "test_deeplabv2_resnet18"
NET = dict(MODEL_NAME="deeplabv2", MODEL_BACKBONE="resnet18", MODEL_ASPP_OUTDIM=64,
           MODEL_ASPP_HASGLOBAL=True)
CKPT = f"model/{EXP}/deeplabv2_resnet18_VOCDataset"


def _in(d, fn, *args):
    cwd = os.getcwd()
    os.makedirs(d, exist_ok=True)
    os.chdir(d)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


def _seg_test(d, flags):
    """Run seg_test in `d`; returns its stdout and the name -> png map."""
    from wseg_tpu_torch.cli import seg_test

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _in(d, seg_test.main, flags + ["--device", "cpu", "--batch_size", "4", "--bucket", "16"])
    folder = os.path.join(d, "results", "Segmentation", "deeplabv2_val")
    return out.getvalue(), {n[:-4]: np.asarray(Image.open(os.path.join(folder, n)))
                            for n in sorted(os.listdir(folder))}


@pytest.fixture(scope="module", autouse=True)
def experiment():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(EXPERIMENTS, EXP, SegConfig(EXP_NAME=EXP, **NET))
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory, experiment):
    from wseg_tpu_torch.cli import seg_train

    base = str(tmp_path_factory.mktemp("stage3"))
    voc, pseudo, names = make_seg_root(base, SIZES)
    common = ["--exp", EXP, "--data_root", voc, "--pseudo_gt", pseudo, "--iterations", "4",
              "--batch_size", "2", "--crop", "48", "--device", "cpu"]
    full, part = os.path.join(base, "full"), os.path.join(base, "part")
    _in(full, seg_train.main, common)
    _in(part, seg_train.main, common + ["--save_state", "--stop_after_epoch", "1"])
    with pytest.raises(SystemExit, match="without --resume"):
        _in(part, seg_train.main, common + ["--min_epoch", "1"])
    _in(part, seg_train.main, common + ["--resume", f"model/{EXP}/seg_train_state.pth",
                                        "--min_epoch", "1"])
    pth = os.path.join(part, CKPT + "_itr4_all.pth")
    flags = ["--exp", EXP, "--data_root", voc, "--ckpt", pth]
    return dict(base=base, voc=voc, names=names, full=full, part=part, pth=pth,
                crf=_seg_test(os.path.join(base, "crf"), flags),
                nocrf=_seg_test(os.path.join(base, "nocrf"), flags + ["--no_crf"]))


def test_seg_train_resume_equals_uninterrupted(runs):
    """A kill after epoch 1 and a resume give the uninterrupted run's weights
    and running stats bit for bit; the weights moved from the seeded init,
    the BN affine did not; the last epoch's checkpoint replaced the one
    before it; the training images were logged."""
    want = load_weights(os.path.join(runs["full"], CKPT + "_itr4_all.pth"))
    got = load_weights(runs["pth"])
    init = generate_net(EXPERIMENTS[EXP], device="cpu",
                        generator=torch.Generator().manual_seed(1)).state_dict()
    assert got.keys() == want.keys() == init.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert not torch.equal(got["backbone.conv1.0.weight"], init["backbone.conv1.0.weight"])
    assert not torch.equal(got["cls_conv.bias"], init["cls_conv.bias"])
    assert not torch.equal(got["aspp.branch5_bn.running_var"],
                           init["aspp.branch5_bn.running_var"])
    assert torch.equal(got["aspp.conv_cat.1.weight"], init["aspp.conv_cat.1.weight"])
    saved = sorted(os.listdir(os.path.join(runs["full"], "model", EXP)))
    assert saved == ["deeplabv2_resnet18_VOCDataset_epoch1.pth",
                     "deeplabv2_resnet18_VOCDataset_itr4_all.pth"]
    images = os.listdir(os.path.join(runs["full"], "log", EXP, "images"))
    assert sorted(images) == ["Input_00000000.png", "Label_00000000.png", "SEG1_00000000.png"]


@pytest.mark.parametrize("crf", [True, False])
def test_seg_test_writes_predictions_and_eval(runs, crf):
    """pngs of every image's size with values in 0..20, the mIoU in
    log/<exp>/logfile.txt, and the end-to-end rate line."""
    d = os.path.join(runs["base"], "crf" if crf else "nocrf")
    out, pngs = runs["crf" if crf else "nocrf"]
    assert sorted(pngs) == runs["names"]
    for (h, w), name in zip(SIZES, runs["names"]):
        assert pngs[name].dtype == np.uint8 and pngs[name].shape == (h, w)
        assert pngs[name].max() <= 20
    log = open(os.path.join(d, "log", EXP, "logfile.txt")).read()
    assert f"{EXP} val" in log and "mIoU:" in log
    assert f"{len(SIZES)} images in " in out and "imgs/s end-to-end" in out


def test_seg_test_reads_jax_ckpt(runs):
    """A JAX `.ckpt` of the trained weights (written by the JAX package's
    save_checkpoint) and the port's `.pth` give the same pngs (--no_crf)."""
    from test_torch_models import random_jax_variables
    from test_torch_seg_models import jax_tree_from_state_dict
    from wseg_tpu.seg.config import SegConfig as JaxSegConfig
    from wseg_tpu.seg.deeplab import generate_net as jax_generate_net
    from wseg_tpu.utils.checkpoint import save_checkpoint

    like = random_jax_variables(jax_generate_net(JaxSegConfig(**NET)), (1, 64, 64, 3))
    ckpt = os.path.join(runs["base"], "seg.ckpt")
    save_checkpoint(ckpt, jax_tree_from_state_dict(load_weights(runs["pth"]), like))
    _, from_ckpt = _seg_test(os.path.join(runs["base"], "ckpt"),
                             ["--exp", EXP, "--data_root", runs["voc"], "--no_crf", "--ckpt",
                              ckpt])
    from_pth = runs["nocrf"][1]
    assert from_ckpt.keys() == from_pth.keys()
    for name in from_pth:
        np.testing.assert_array_equal(from_ckpt[name], from_pth[name])


def test_seg_cli_guards(runs, tmp_path, monkeypatch):
    """seg_test with the accelerator CRF (--crf_backend tpu) on --device
    cpu: every CRF call's Q against the JAX package's dense_crf_tpu (what
    its seg_test calls for the tpu backend) on the same probabilities and
    image, within 1e-4 and with the same argmax, and each
    png is its image's argmax. Without a GPU the default device raises,
    with either CRF, before any work."""
    from wseg_tpu.ops.crf import dense_crf_tpu as jax_dense_crf_tpu
    from wseg_tpu_torch.cli import seg_test, seg_train
    from wseg_tpu_torch.ops import crf

    calls = []

    def recording(probs, img, **kw):
        q = dense_crf_tpu(probs, img, **kw)
        calls.append((probs, img, q))
        return q

    dense_crf_tpu = crf.dense_crf_tpu
    monkeypatch.setattr(crf, "dense_crf_tpu", recording)
    _, pngs = _seg_test(os.path.join(runs["base"], "tpu"),
                        ["--exp", EXP, "--data_root", runs["voc"], "--ckpt", runs["pth"],
                         "--crf_backend", "tpu"])
    assert len(calls) == len(SIZES) and sorted(pngs) == runs["names"]
    by_shape = {q.shape[1:]: q for _, _, q in calls}
    for probs, img, q in calls:
        want = jax_dense_crf_tpu(probs, img)
        assert q.shape == want.shape and np.abs(q - want).max() <= 1e-4
        np.testing.assert_array_equal(q.argmax(0), want.argmax(0))
    for (h, w), name in zip(SIZES, runs["names"]):
        np.testing.assert_array_equal(pngs[name], by_shape[(h, w)].argmax(0))
    if not torch.cuda.is_available():
        for backend in ("native", "tpu"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                seg_test.main(["--data_root", runs["voc"], "--ckpt", runs["pth"],
                               "--crf_backend", backend])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _in(str(tmp_path), seg_train.main, ["--data_root", runs["voc"]])
