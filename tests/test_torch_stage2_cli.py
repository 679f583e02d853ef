"""Stage 2 of the port from its command lines, on the CPU, against the JAX
package's on the same inputs: contrast_infer --out_cam --out_crf, then
aff_prepare (the 5-alpha sweep), aff_train (crop 64, one epoch, then a kill
and a resume), then aff_infer. Weights are random from a seed; the VOC root
is synthetic."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.utils.checkpoint import load_weights, save_weights

# three images in one 64x64 bucket
SIZES = [(56, 64), (60, 50), (64, 61)]
CATS = ["dog", "cat", "person"]


def _pngs(folder, names):
    return [np.asarray(Image.open(os.path.join(folder, n + ".png"))) for n in names]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Run the port's chain once; every test reads its outputs."""
    from wseg_tpu_torch.cli import aff_prepare, aff_train, contrast_infer

    root = tmp_path_factory.mktemp("stage2")
    voc = root / "VOC2012"
    (voc / "JPEGImages").mkdir(parents=True)
    (voc / "Annotations").mkdir()
    rng = np.random.RandomState(0)
    names = []
    for i, ((h, w), cat) in enumerate(zip(SIZES, CATS)):
        name = f"2007_{i:06d}"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            voc / "JPEGImages" / f"{name}.jpg")
        (voc / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><object><name>{cat}</name></object></annotation>")
        names.append(name)
    lst = root / "list.txt"
    lst.write_text("".join(n + "\n" for n in names))
    contrast_pth = str(root / "contrast.pth")
    save_weights(contrast_pth, build_model("contrast", device="cpu",
                                           generator=torch.Generator().manual_seed(5)))

    d = dict(root=root, voc=str(voc), lst=str(lst), names=names, contrast_pth=contrast_pth,
             cam=str(root / "cam"), crf_png=str(root / "crf_png"), crf=str(root / "crf"))
    contrast_infer.main(["--weights", contrast_pth, "--infer_list", d["lst"], "--voc12_root",
                         d["voc"], "--out_cam", d["cam"], "--out_crf", d["crf_png"],
                         "--crf_iters", "3", "--num_workers", "2", "--device", "cpu"])
    aff_prepare.main(["--infer_list", d["lst"], "--voc12_root", d["voc"], "--cam_dir", d["cam"],
                      "--out_crf", d["crf"], "--crf_iters", "3", "--num_workers", "2"])

    common = ["--train_list", d["lst"], "--voc12_root", d["voc"], "--batch_size", "3",
              "--crop_size", "64", "--num_workers", "2", "--max_epoches", "2",
              "--la_crf_dir", os.path.join(d["crf"], "4.00"),
              "--ha_crf_dir", os.path.join(d["crf"], "24.00"),
              "--weights", contrast_pth, "--device", "cpu"]
    cwd = os.getcwd()
    os.chdir(root)
    try:
        aff_train.main(common + ["--session_name", "full"])
        aff_train.main(common + ["--session_name", "part", "--save_every_epoch",
                                 "--stop_after_epoch", "1"])
        with pytest.raises(SystemExit):  # --start_epoch without --resume
            aff_train.main(common + ["--session_name", "part", "--start_epoch", "1"])
        aff_train.main(common + ["--session_name", "part", "--start_epoch", "1",
                                 "--resume", "result/part/aff_train.pth"])
    finally:
        os.chdir(cwd)
    d["aff_pth"] = str(root / "result" / "part" / "aff.pth")
    d["aff_full_pth"] = str(root / "result" / "full" / "aff.pth")
    return d


def test_contrast_infer_crf_pngs_equal_jax(chain):
    """--out_crf pngs equal the JAX crf_from_cam_dict's on the same cam dict
    and image."""
    from wseg_tpu.data.voc12 import get_img_path
    from wseg_tpu.infer.crf_post import crf_from_cam_dict

    ref = str(chain["root"] / "ref_crf_png")
    for name in chain["names"]:
        cam_dict = np.load(os.path.join(chain["cam"], name + ".npy"), allow_pickle=True).item()
        crf_from_cam_dict(cam_dict, get_img_path(name, chain["voc"]),
                          os.path.join(ref, name + ".png"), t=3)
    for (h, w), got, want in zip(SIZES, _pngs(chain["crf_png"], chain["names"]),
                                 _pngs(ref, chain["names"])):
        assert got.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want)


def test_aff_prepare_equals_jax(chain):
    """Every alpha's subdirectory and score array equal the JAX CLI's."""
    from wseg_tpu.cli import aff_prepare as jax_aff_prepare

    ref = str(chain["root"] / "ref_crf")
    jax_aff_prepare.main(["--infer_list", chain["lst"], "--voc12_root", chain["voc"],
                          "--cam_dir", chain["cam"], "--out_crf", ref, "--crf_iters", "3",
                          "--num_workers", "2"])
    assert sorted(os.listdir(chain["crf"])) == sorted(os.listdir(ref)) == \
        ["16.00", "24.00", "32.00", "4.00", "8.00"]
    for alpha in os.listdir(ref):
        for name, (h, w) in zip(chain["names"], SIZES):
            got = np.load(os.path.join(chain["crf"], alpha, name + ".npy"))
            assert got.shape == (21, h, w) and got.dtype == np.float32
            np.testing.assert_array_equal(
                got, np.load(os.path.join(ref, alpha, name + ".npy")))


def test_aff_train_resume_equals_uninterrupted(chain):
    """A kill after epoch 1 and a resume give the uninterrupted run's weights,
    bit for bit; the stage-1 weights loaded into the trunk and trained."""
    want, got = load_weights(chain["aff_full_pth"]), load_weights(chain["aff_pth"])
    assert want.keys() == got.keys() == build_model("affinity", device="cpu").state_dict().keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    contrast = load_weights(chain["contrast_pth"])
    torch.testing.assert_close(got["conv1a.weight"], contrast["conv1a.weight"], rtol=0, atol=0)
    assert not torch.equal(got["b7.conv_branch2a.weight"], contrast["b7.conv_branch2a.weight"])


def test_aff_infer_matches_jax(chain):
    """From the same JAX `.ckpt` (--logt 2): the port's pngs equal the JAX
    CLI's except at pixels whose top-2 margin in the port's refined scores is
    below 1e-4."""
    from wseg_tpu.cli import aff_infer as jax_aff_infer
    from wseg_tpu.utils.checkpoint import convert_torch_state_dict, save_checkpoint
    from wseg_tpu_torch.cli import aff_infer
    from wseg_tpu_torch.data.transforms import Normalize
    from wseg_tpu_torch.infer.rw import RandomWalkRefiner

    sd = load_weights(chain["aff_pth"])
    sd["f9.weight"] *= 0.01  # affinities of about (0.1, 0.5), not 0: the walk mixes
    params, stats = convert_torch_state_dict(sd)
    ckpt = str(chain["root"] / "aff.ckpt")
    save_checkpoint(ckpt, {"params": params, "batch_stats": stats})
    flags = ["--weights", ckpt, "--infer_list", chain["lst"], "--voc12_root", chain["voc"],
             "--cam_dir", chain["cam"], "--logt", "2", "--num_workers", "2"]
    out, ref = str(chain["root"] / "rw"), str(chain["root"] / "ref_rw")
    aff_infer.main(flags + ["--out_rw", out, "--device", "cpu"])
    jax_aff_infer.main(flags + ["--out_rw", ref])

    model = build_model("affinity", device="cpu")
    model.load_state_dict(load_weights(ckpt), strict=True)
    refiner = RandomWalkRefiner(model, logt=2)
    for name, (h, w), got, want in zip(chain["names"], SIZES, _pngs(out, chain["names"]),
                                       _pngs(ref, chain["names"])):
        assert got.dtype == np.uint8 and got.shape == (h, w) and got.max() <= 20
        assert len(np.unique(want)) > 1  # the walk's argmax is not one class
        img = Normalize()(np.asarray(Image.open(os.path.join(chain["voc"], "JPEGImages",
                                                             name + ".jpg")).convert("RGB")))
        cam_dict = np.load(os.path.join(chain["cam"], name + ".npy"), allow_pickle=True).item()
        cam = np.zeros((h, w, 21), np.float32)
        for k, v in cam_dict.items():
            cam[..., k + 1] = v
        cam[..., 0] = 0.27
        scores = refiner.walk_scores(*refiner.pad([(img, cam)]))[0, :, :h, :w]
        top2 = scores.topk(2, dim=0).values
        close = (top2[0] - top2[1] < 1e-4).numpy()
        assert np.array_equal(got[~close], want[~close])
        assert np.array_equal(got, scores.argmax(0).numpy())


def test_cli_device_and_backend_guards(chain, tmp_path):
    """aff_prepare's accelerator CRF (--crf_backend tpu) on --device cpu
    against the JAX CLI's tpu output on the same cams: every alpha's scores
    within 1e-4 and the same argmax. The GPU is the
    default: without one, the tpu backend and the net CLIs raise before any
    work."""
    from wseg_tpu.cli import aff_prepare as jax_aff_prepare
    from wseg_tpu_torch.cli import aff_infer, aff_prepare, aff_train

    flags = ["--infer_list", chain["lst"], "--voc12_root", chain["voc"], "--cam_dir",
             chain["cam"], "--crf_iters", "3", "--num_workers", "2", "--crf_backend", "tpu"]
    got_dir, want_dir = tmp_path / "tpu", tmp_path / "ref_tpu"
    aff_prepare.main(flags + ["--out_crf", str(got_dir), "--device", "cpu"])
    jax_aff_prepare.main(flags + ["--out_crf", str(want_dir)])
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for alpha in os.listdir(want_dir):
        for name, (h, w) in zip(chain["names"], SIZES):
            got = np.load(got_dir / alpha / f"{name}.npy")
            want = np.load(want_dir / alpha / f"{name}.npy")
            assert got.shape == want.shape == (21, h, w) and got.dtype == np.float32
            assert np.abs(got - want).max() <= 1e-4
            np.testing.assert_array_equal(got.argmax(0), want.argmax(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            aff_prepare.main(["--infer_list", chain["lst"], "--cam_dir", chain["cam"],
                              "--out_crf", str(tmp_path / "x"), "--crf_backend", "tpu"])
        assert not (tmp_path / "x").exists()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            aff_infer.main(["--weights", chain["aff_pth"], "--cam_dir", chain["cam"],
                            "--infer_list", chain["lst"], "--voc12_root", chain["voc"]])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            aff_train.main(["--la_crf_dir", "x", "--ha_crf_dir", "y", "--train_list",
                            chain["lst"], "--voc12_root", chain["voc"]])
