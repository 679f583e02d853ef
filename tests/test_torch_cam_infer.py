"""The port's stage-1 CAM inference (infer/cam.py, the CLIs) against the JAX
package's on the same weights and inputs, f32 on the CPU (plain PCM)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_models import (  # noqa: F401 (drop_tmp_path: an autouse fixture)
    port_model_from_jax, random_jax_variables, drop_tmp_path,
)

from wseg_tpu.data import transforms as jT
from wseg_tpu.infer import cam as jcam
from wseg_tpu.models import build_model as jax_build_model
from wseg_tpu_torch.infer import cam as tcam

SCALES = (0.5, 1.0, 1.5, 2.0)


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model("contrast", fused_pcm=False)
    variables = random_jax_variables(jmodel, (1, 32, 32, 3), seed=11)
    return jmodel, variables, port_model_from_jax(variables)


def _image(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _views(img):
    norm = jT.Normalize()
    return [norm(v) for v in jT.msf_views(Image.fromarray(img), SCALES, 1)]


LABEL = np.zeros(20, np.float32)
LABEL[[2, 7, 14]] = 1.0


def test_fused_msf_fn(models):
    jmodel, variables, tmodel = models
    h0, w0, b = 32, 48, 2
    rng = np.random.RandomState(0)
    views = [rng.randn(b, 2, round(h0 * s), round(w0 * s), 3).astype(np.float32)
             for s in SCALES]
    label = (rng.rand(b, 20) > 0.5).astype(np.float32)
    want = np.asarray(jcam.make_fused_msf_fn(jmodel, (h0, w0))(
        variables, tuple(jnp.asarray(v) for v in views), jnp.asarray(label)))
    fn = tcam.make_fused_msf_fn(tmodel, (h0, w0))
    got = fn(tuple(torch.from_numpy(v.transpose(0, 1, 4, 2, 3).copy()) for v in views),
             torch.from_numpy(label))
    assert got.shape == (b, 20, h0, w0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bucket", [None, 16])
def test_infer_one(models, bucket):
    jmodel, variables, tmodel = models
    img = _image(27, 37, 1)
    views = _views(img)
    want = jcam.CamInferencer(jmodel, variables, bucket=bucket).infer_one(views, LABEL, (27, 37))
    got = tcam.CamInferencer(tmodel, bucket=bucket).infer_one(views, LABEL, (27, 37))
    assert got.shape == (20, 27, 37)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_infer_batch(models):
    jmodel, variables, tmodel = models
    items = []
    for i, (h, w) in enumerate([(27, 37), (33, 22)]):
        label = np.zeros(20, np.float32)
        label[[i, 9 + i]] = 1.0
        items.append((_views(_image(h, w, 2 + i)), label, (h, w)))
    want = jcam.CamInferencer(jmodel, variables, bucket=16).infer_batch(items)
    got = tcam.CamInferencer(tmodel, bucket=16).infer_batch(items)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, wnt, rtol=0, atol=1e-4)


def test_infer_one_device(models):
    jmodel, variables, tmodel = models
    img = _image(29, 35, 4)
    want = jcam.CamInferencer(jmodel, variables, device_msf=True).infer_one_device(img, LABEL)
    got = tcam.CamInferencer(tmodel).infer_one_device(img, LABEL)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _synthetic_voc(root):
    """The synthetic VOC root of the verify recipe, plus ground-truth pngs."""
    voc = root / "VOC2012"
    (voc / "JPEGImages").mkdir(parents=True)
    (voc / "Annotations").mkdir()
    (voc / "SegmentationClass").mkdir()
    rng = np.random.RandomState(0)
    xml = "<annotation><object><name>{c}</name></object></annotation>"
    names = []
    for name, c, size in [("2007_000001", "dog", (128, 96)), ("2007_000002", "cat", (100, 140))]:
        Image.fromarray((rng.rand(size[1], size[0], 3) * 255).astype(np.uint8)).save(
            voc / "JPEGImages" / f"{name}.jpg")
        (voc / "Annotations" / f"{name}.xml").write_text(xml.format(c=c))
        gt = rng.choice([0, 8, 12, 255], size=(size[1], size[0])).astype(np.uint8)
        Image.fromarray(gt).save(voc / "SegmentationClass" / f"{name}.png")
        names.append(name)
    lst = root / "infer_list.txt"
    lst.write_text("".join(n + "\n" for n in names))
    return str(voc), str(lst), names


def test_msf_dataset_matches_jax(tmp_path):
    from wseg_tpu.data import voc12 as jvoc
    from wseg_tpu_torch.data import voc12 as tvoc

    voc, lst, names = _synthetic_voc(tmp_path)
    ref_list = tmp_path / "ref_format.txt"
    ref_list.write_text("".join(f"/JPEGImages/{n}.jpg /SegmentationClassAug/{n}.png\n"
                                for n in names))
    assert tvoc.load_img_name_list(str(ref_list)) == jvoc.load_img_name_list(str(ref_list))
    assert tvoc.CATEGORIES_WITH_BG == jvoc.CATEGORIES_WITH_BG
    want_ds, got_ds = jvoc.VOC12ClsDatasetMSF(lst, voc), tvoc.VOC12ClsDatasetMSF(lst, voc)
    assert len(got_ds) == len(want_ds) == len(names)
    for i in range(len(names)):
        (gn, gv, gl, ghw), (wn, wv, wl, whw) = got_ds[i], want_ds[i]
        assert (gn, ghw) == (wn, whw)
        np.testing.assert_array_equal(gl, wl)
        assert len(gv) == len(wv) == 2 * len(SCALES)
        for a, b in zip(gv, wv):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_cli_outputs_match_jax(models, tmp_path):
    from wseg_tpu.cli import eval as jax_eval
    from wseg_tpu.data.voc12 import VOC12ClsDatasetMSF
    from wseg_tpu.utils.checkpoint import save_checkpoint
    from wseg_tpu_torch.cli import contrast_infer, eval as port_eval

    jmodel, variables, _ = models
    voc, lst, names = _synthetic_voc(tmp_path)
    ckpt = str(tmp_path / "w.ckpt")
    save_checkpoint(ckpt, variables)
    out_cam, out_pred = str(tmp_path / "cam"), str(tmp_path / "pred")
    contrast_infer.main(["--weights", ckpt, "--infer_list", lst, "--voc12_root", voc,
                         "--out_cam", out_cam, "--out_cam_pred", out_pred,
                         "--device", "cpu"])

    ref_cam, ref_pred = str(tmp_path / "ref_cam"), str(tmp_path / "ref_pred")
    inferencer = jcam.CamInferencer(jmodel, variables, bucket=64)
    for name, views, label, hw in VOC12ClsDatasetMSF(lst, voc):
        norm_cam = inferencer.infer_one(views, np.asarray(label), hw)
        jcam.save_cam_dict(ref_cam, name, norm_cam, label)
        jcam.save_cam_pred(ref_pred, name, norm_cam)

    for name in names:
        got = np.load(os.path.join(out_cam, name + ".npy"), allow_pickle=True).item()
        want = np.load(os.path.join(ref_cam, name + ".npy"), allow_pickle=True).item()
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4)
        pg = np.asarray(Image.open(os.path.join(out_pred, name + ".png")))
        pw = np.asarray(Image.open(os.path.join(ref_pred, name + ".png")))
        assert pg.shape == pw.shape and pg.dtype == pw.dtype
        assert (pg == pw).mean() >= 0.999

    # both eval CLIs on the port's seeds: the same IoU table
    logs = []
    for mod, tag in [(port_eval, "port"), (jax_eval, "jax")]:
        log = str(tmp_path / f"{tag}_eval.txt")
        mod.main(["--list", lst, "--predict_dir", out_pred, "--gt_dir",
                  os.path.join(voc, "SegmentationClass"), "--logfile", log, "--comment", "x"])
        logs.append(open(log).read().splitlines()[1])  # the metric line
    assert logs[0] == logs[1]


def test_cli_rejects_crf_and_missing_gpu(models, tmp_path):
    """contrast_infer --out_crf with the accelerator CRF (--crf_backend tpu)
    on --device cpu: its pngs equal the JAX crf_from_cam_dict's tpu backend
    on the same cam dicts and images. The GPU is the default: without one,
    the CLI with the tpu backend raises before any work, as build_model
    does."""
    from wseg_tpu.infer.crf_post import crf_from_cam_dict
    from wseg_tpu.utils.checkpoint import save_checkpoint
    from wseg_tpu_torch.cli import contrast_infer
    from wseg_tpu_torch.data.voc12 import get_img_path
    from wseg_tpu_torch.models import build_model

    _, variables, _ = models
    voc, lst, names = _synthetic_voc(tmp_path)
    ckpt = str(tmp_path / "w.ckpt")
    save_checkpoint(ckpt, variables)
    out_cam, out_crf = tmp_path / "cam", tmp_path / "crf"
    flags = ["--weights", ckpt, "--infer_list", lst, "--voc12_root", voc, "--out_crf",
             str(out_crf), "--crf_iters", "3", "--crf_backend", "tpu"]
    contrast_infer.main(flags + ["--out_cam", str(out_cam), "--device", "cpu"])
    for name in names:
        cam_dict = np.load(out_cam / f"{name}.npy", allow_pickle=True).item()
        want = crf_from_cam_dict(cam_dict, get_img_path(name, voc),
                                 str(tmp_path / "ref" / f"{name}.png"), t=3, backend="tpu")
        got = np.asarray(Image.open(out_crf / f"{name}.png"))
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            contrast_infer.main(flags[:-2] + ["--crf_backend", "tpu"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model("contrast")
