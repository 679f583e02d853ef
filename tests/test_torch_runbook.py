"""The port's runbook pieces on the CPU: make_cls_labels against the JAX
CLI's output, the reproduce runbook's stage chain (its stage runner replaced
by a recorder), the stdout tee and contrast_train's --profile_dir trace."""

import json
import os
import sys

import numpy as np
import pytest

from test_torch_train import _make_voc

CATS = ["dog", "cat", "person", "car", "bus"]


def test_make_cls_labels_equals_jax(tmp_path):
    """The label dict from synthetic XML (several objects, a repeated name
    across the two lists, an unknown class) equals the JAX CLI's."""
    from wseg_tpu.cli import make_cls_labels as jax_make_cls_labels
    from wseg_tpu_torch.cli import make_cls_labels

    root = tmp_path / "VOC2012"
    (root / "Annotations").mkdir(parents=True)
    names = [f"2007_{i:06d}" for i in range(5)]
    for i, name in enumerate(names):
        objs = "".join(f"<object><name>{c}</name></object>"
                       for c in (CATS[i], CATS[(i + 2) % 5], "unicorn"))
        (root / "Annotations" / f"{name}.xml").write_text(f"<annotation>{objs}</annotation>")
    (tmp_path / "train.txt").write_text("".join(n + "\n" for n in names[:4]))
    (tmp_path / "val.txt").write_text("".join(n + "\n" for n in names[3:]))
    outs = []
    for mod, tag in [(make_cls_labels, "port"), (jax_make_cls_labels, "jax")]:
        out = str(tmp_path / f"{tag}.npy")
        mod.main(["--voc12_root", str(root), "--train_list", str(tmp_path / "train.txt"),
                  "--val_list", str(tmp_path / "val.txt"), "--out", out])
        outs.append(np.load(out, allow_pickle=True).item())
    got, want = outs
    assert list(got) == list(want) == names
    for name in names:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].sum() == 2


def test_reproduce_chain_reads_what_each_cli_writes(tmp_path, monkeypatch):
    """With its stage runner replaced by a recorder: the ten stages run the
    port's CLIs in order; each stage reads the file the stage before it
    writes (under --work, by the CLIs' own names); --device goes to every
    stage that runs a net or the CRF and --crf_backend to aff_prepare and
    seg_test."""
    from wseg_tpu_torch.cli import aff_train, contrast_train, reproduce, seg_train
    from wseg_tpu_torch.seg.config import EXPERIMENTS

    calls = []
    monkeypatch.setattr(reproduce, "_run", lambda tag, module, flags, cwd: calls.append(
        (tag, module, [str(f) for f in flags], cwd)))
    work = str(tmp_path / "work")
    reproduce.main(["--voc12_root", str(tmp_path / "VOC2012"), "--weights", "w.params",
                    "--work", work, "--crf_backend", "tpu", "--device", "cpu",
                    "--seg_iterations", "6", "--train_list", "t.txt", "--eval_list", "e.txt"])
    assert [m for _, m, _, _ in calls] == [
        "contrast_train", "contrast_infer", "eval", "aff_prepare", "aff_train", "aff_infer",
        "eval", "aff_infer", "seg_train", "seg_test"]
    assert all(cwd == work for *_, cwd in calls)
    flags = [dict(zip(f[::2], f[1::2])) for _, _, f, _ in calls]
    for (_, module, _, _), f in zip(calls, flags):
        assert (f.get("--device") == "cpu") == (module != "eval")
        assert ("--crf_backend" in f) == (module in ("aff_prepare", "seg_test"))
    c_train, c_infer, seed_eval, prep, a_train, rw_eval_infer, rw_eval, pseudo, s_train, s_test \
        = flags
    assert c_train["--weights"].endswith("w.params") and c_train["--session_name"] == "contrast"
    assert c_infer["--weights"] == os.path.join(work, "result", c_train["--session_name"],
                                                contrast_train.WEIGHTS)
    assert seed_eval["--predict_dir"] == c_infer["--out_cam"] == prep["--cam_dir"]
    assert a_train["--la_crf_dir"] == os.path.join(prep["--out_crf"], "4.00")
    assert a_train["--ha_crf_dir"] == os.path.join(prep["--out_crf"], "24.00")
    for infer in (rw_eval_infer, pseudo):
        assert infer["--weights"] == os.path.join(work, "result", a_train["--session_name"],
                                                  aff_train.WEIGHTS)
    assert rw_eval["--predict_dir"] == rw_eval_infer["--out_rw"]
    assert s_train["--pseudo_gt"] == pseudo["--out_rw"]
    assert s_train["--backbone_weights"].endswith("w.params")
    cfg = EXPERIMENTS[s_train["--exp"]]
    assert s_test["--ckpt"] == os.path.join(work, seg_train.weights_path(cfg, "itr6_all"))
    assert s_test["--crf_backend"] == prep["--crf_backend"] == "tpu"

    calls.clear()
    reproduce.main(["--voc12_root", "r", "--weights", "w", "--work", work, "--stages", "2",
                    "--alphas", "4,24"])
    assert [t for t, *_ in calls][:2] == ["2/aff_prepare_a4", "2/aff_prepare_a24"]
    with pytest.raises(SystemExit, match="--stages"):
        reproduce.main(["--voc12_root", "r", "--weights", "w", "--work", work, "--stages", "4"])


def test_logger_tees_stdout_to_a_file(tmp_path, capsys):
    """Inside the block stdout goes to the terminal and the file; after it,
    stdout is restored and the file closed."""
    from wseg_tpu_torch.utils.logging import Logger

    before = sys.stdout
    path = tmp_path / "a" / "b" / "run.log"
    with Logger(str(path)) as log:
        print("hello", 3)
        sys.stdout.flush()
    print("after")
    assert sys.stdout is before and log.log.closed
    assert path.read_text() == "hello 3\n"
    assert capsys.readouterr().out == "hello 3\nafter\n"


def test_contrast_train_profile_dir_traces_steps_10_to_14(tmp_path):
    """A 16-step CPU run with --profile_dir writes one Chrome trace holding
    the five train_step spans of steps 10-14."""
    from wseg_tpu_torch.cli import contrast_train

    root, train_list = _make_voc(str(tmp_path / "VOC2012"), n=16, size=(40, 32))
    prof = tmp_path / "prof"
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        contrast_train.main([
            "--device", "cpu", "--train_list", train_list, "--voc12_root", root,
            "--batch_size", "1", "--crop_size", "32", "--low_res", "16", "--min_long", "32",
            "--max_long", "40", "--num_workers", "2", "--tblog_dir", str(tmp_path / "tb"),
            "--grad_clip", "5.0", "--max_epoches", "1", "--profile_dir", str(prof)])
    finally:
        os.chdir(cwd)
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    events = json.loads((prof / traces[0]).read_text())["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 5
