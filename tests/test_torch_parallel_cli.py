"""The data-parallel CLIs of the port on gloo CPU ranks, started as torchrun
starts them (parallel/launch.py:spawn(torchrun=True): RANK, WORLD_SIZE,
LOCAL_RANK and the address of a store that the test process hosts on a
port the kernel picks; each spawn with its own timeout), so each CLI joins
the group itself through parallel/mesh.py:joined: `contrast_infer` over 2
ranks against one process, file for file, and `contrast_train` over 2 ranks
against one process, log line for log line."""

import contextlib
import io
import os
import re

import numpy as np
import torch
from PIL import Image

from test_torch_models import drop_tmp_path  # noqa: F401 (an autouse fixture)
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.parallel.launch import spawn
from wseg_tpu_torch.utils.checkpoint import save_weights

TESTS = os.path.dirname(os.path.abspath(__file__))


def _voc(root, sizes):
    """A synthetic VOC root: one jpg and one class annotation an image."""
    voc = root / "VOC2012"
    (voc / "JPEGImages").mkdir(parents=True)
    (voc / "Annotations").mkdir()
    rng = np.random.RandomState(0)
    xml = "<annotation><object><name>{c}</name></object></annotation>"
    names = []
    for i, (w, h) in enumerate(sizes):
        name = f"2007_{i:06d}"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            voc / "JPEGImages" / f"{name}.jpg")
        (voc / "Annotations" / f"{name}.xml").write_text(
            xml.format(c=["dog", "cat", "bird", "car", "person"][i % 5]))
        names.append(name)
    lst = root / "infer_list.txt"
    lst.write_text("".join(n + "\n" for n in names))
    return str(voc), str(lst), names


def test_contrast_infer_over_2_ranks_equals_one_process(tmp_path):
    """5 small images of 4 sizes (every view in the 64 bucket) over 2 ranks
    (2 and 3 images, batches of 2): the ranks' cam dicts and argmax pngs,
    each written by exactly one rank, equal the one-process run's within
    the CPU's thread-count rounding: cams within 1e-5 absolute (measured
    6.6e-7 with 1 thread a rank against the test's own), argmax pngs on
    99.9% of the pixels (a rank's batches hold other images than the one
    process's; the bucketed, masked forward makes each image's output its
    own)."""
    voc, lst, names = _voc(tmp_path, [(32, 24), (24, 32), (32, 32), (32, 24), (28, 20)])
    weights = str(tmp_path / "c.pth")
    save_weights(weights, build_model("contrast", device="cpu",
                                      generator=torch.Generator().manual_seed(5)))

    def argv(tag):
        return ["--weights", weights, "--infer_list", lst, "--voc12_root", voc,
                "--out_cam", str(tmp_path / tag / "cam"),
                "--out_cam_pred", str(tmp_path / tag / "pred"),
                "--batch_size", "2", "--num_workers", "2", "--device", "cpu"]

    from wseg_tpu_torch.cli import contrast_infer

    ranks = spawn("torch_dp_workers:contrast_infer", 2, tmp_path / "ranks",
                  dict(argv=argv("dp")), timeout=300.0, pythonpath=[TESTS], torchrun=True)
    assert [r["written"] for r in ranks] == [names[:2], names[2:]]
    assert [r["joined"] for r in ranks] == [{("gloo", 0, 2)}, {("gloo", 1, 2)}]
    assert all(r["left"] for r in ranks)  # joined() destroyed the group it made
    with contextlib.redirect_stdout(io.StringIO()):
        contrast_infer.main(argv("one"))
    for sub, ext in (("cam", ".npy"), ("pred", ".png")):
        assert sorted(os.listdir(tmp_path / "dp" / sub)) == [n + ext for n in names]
    for name in names:
        got = np.load(tmp_path / "dp" / "cam" / f"{name}.npy", allow_pickle=True).item()
        want = np.load(tmp_path / "one" / "cam" / f"{name}.npy", allow_pickle=True).item()
        assert got.keys() == want.keys() and want
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
        pg, pw = (np.asarray(Image.open(tmp_path / tag / "pred" / f"{name}.png"))
                  for tag in ("dp", "one"))
        assert pg.shape == pw.shape and (pg == pw).mean() >= 0.999


def test_contrast_train_over_2_ranks_equals_one_process(tmp_path):
    """The stage-1 training CLI on 2 ranks at global batch 2 (2 epochs of one
    step, a train state each epoch) against one process: rank 0 alone
    writes the log, whose lines equal the one process's but for the clock
    (images/s, finish time) and the printed losses, which agree within rtol
    1e-4 plus one unit of their last printed digit; the final weights within
    atol 5e-5 / rtol 1e-3 (tests/test_cli_train_dp.py's); the train state
    holds step 2."""
    voc, lst, _ = _voc(tmp_path, [(56, 48), (48, 64)])

    def argv(session):
        return ["--device", "cpu", "--train_list", lst, "--voc12_root", voc,
                "--batch_size", "2", "--crop_size", "48", "--low_res", "32",
                "--min_long", "48", "--max_long", "80", "--num_workers", "2",
                "--session_name", session, "--tblog_dir", str(tmp_path / "tblog" / session),
                "--grad_clip", "5.0", "--max_epoches", "2", "--save_every_epoch"]

    from wseg_tpu_torch.cli import contrast_train
    from wseg_tpu_torch.utils.checkpoint import load_weights

    left = spawn("torch_dp_workers:cli", 2, tmp_path / "ranks",
                 dict(module="wseg_tpu_torch.cli.contrast_train", argv=argv("dp"),
                      cwd=str(tmp_path)),
                 timeout=300.0, pythonpath=[TESTS], torchrun=True)
    assert left == [True, True]
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            contrast_train.main(argv("one"))
    finally:
        os.chdir(cwd)

    number = re.compile(r"-?\d+\.\d+")

    def log(session):
        """The log's lines without the clock, the session name and the
        printed args; the printed losses apart."""
        lines = (tmp_path / "result" / session / "contrast.log").read_text().splitlines()
        lines = [line.split("imps:")[0].replace(session, "S") for line in lines
                 if not line.startswith(("Session started", "{"))]
        return ([number.sub("#", line) for line in lines],
                [float(x) for line in lines for x in number.findall(line)])

    (got_lines, got), (want_lines, want) = log("dp"), log("one")
    assert got_lines == want_lines and len(want) == 8  # the 8 losses of step 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want = load_weights(str(tmp_path / "result" / "one" / "contrast.pth"))
    got = load_weights(str(tmp_path / "result" / "dp" / "contrast.pth"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-5, rtol=1e-3,
                                   err_msg=k)
    assert torch.load(tmp_path / "result" / "dp" / "contrast_train.pth")["step"] == 2
