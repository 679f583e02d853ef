"""The port's benchmark CLI (wseg_tpu_torch/cli/bench.py) on the CPU: both
modes print one JSON line with the JAX bench.py's keys and metric names, the
card-only fields null; and the two paths `--mode cam` compares compute the
same fused CAM on the full-width contrast net and bench.py's inputs (the
reference-style per-view path with the literal host fusion, and the fused
path, which tests/test_torch_cam_infer.py holds against the JAX package's
make_fused_msf_fn), within 1e-4. The cam-mode CLI runs on a small stand-in
net with the contrast net's inference interface, so it tests the CLI's
loops and output, not the net."""

import io
import json
from contextlib import redirect_stdout

import numpy as np
import torch
import torch.nn.functional as F

from test_torch_cam_infer import SCALES
from test_torch_models import port_model_from_jax, random_jax_variables
from wseg_tpu.models import build_model as jax_build_model
from wseg_tpu_torch.cli import bench
from wseg_tpu_torch.infer import cam as tcam


class StandInCamNet(torch.nn.Module):
    """(cam, PCM-refined cam) at stride 8, as ContrastNet(raw_cam=True)
    gives them, from an 8x8 mean pool and a 1x1 conv."""

    def __init__(self):
        super().__init__()
        self.fc8 = torch.nn.Conv2d(3, 21, 1, bias=False)

    def forward(self, x, raw_cam=False):
        cam = self.fc8(F.avg_pool2d(x, 8, ceil_mode=True))
        return cam, torch.relu(cam)


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        returned = bench.main(argv + ["--device", "cpu"])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(lines) == 1, f"bench prints ONE JSON line, got: {lines}"
    result = json.loads(lines[0])
    assert result == json.loads(json.dumps(returned))
    assert {"metric", "value", "unit", "vs_baseline", "detail"} <= result.keys()
    assert result["unit"] == "imgs/sec/chip" and result["value"] > 0
    assert result["detail"]["device"] == "cpu"
    return result


def test_cam_mode_prints_one_line(monkeypatch):
    """The fused path and the reference-style baseline (2 reps) at 32 x 48,
    batch 2: vs_baseline present, per-image samples of every rep, the FLOP
    count of one image's 8 views, the card-only fields null."""
    import wseg_tpu_torch.models

    monkeypatch.setattr(wseg_tpu_torch.models, "build_model",
                        lambda name, device="cuda", **kw: StandInCamNet().to(device))
    r = _run(["--height", "32", "--width", "48", "--batch", "2", "--iters", "2", "--warmup", "1",
              "--baseline_reps", "2", "--fused_pcm"])
    d = r["detail"]
    assert r["metric"] == "CAM imgs/sec/chip (ms+flip infer)"
    assert r["vs_baseline"] > 0 and d["reference_style_ips"] > 0
    assert d["baseline_reps"] == 2 and d["baseline_img_samples"] == 4 and d["fused_pcm"] is True
    assert d["image_hw"] == [32, 48] and d["dtype"] == "bfloat16" and d["batch"] == 2
    assert d["flop_per_image"] > 0 and d["host_fuse_ms"]["median"] >= 0
    for k in ("sync_rtt_ms", "physical_ceiling_ips", "pct_of_physical_ceiling"):
        assert d[k] is None, k
    assert d["pcm_launches_per_batch"].startswith("plain")


def test_train_mode_prints_one_line():
    r = _run(["--mode", "train", "--height", "32", "--batch", "1", "--iters", "1",
              "--warmup", "0"])
    assert r["metric"] == "train imgs/sec/chip (stage-1 dual-view step)"
    assert r["vs_baseline"] is None
    d = r["detail"]
    assert (d["crop"], d["batch"], d["dtype"]) == (32, 1, "float32")
    assert np.isfinite(d["loss0"]) and d["first_step_s"] >= 0


def test_both_paths_compute_the_same_fused_cam():
    """bench.py's draws (numpy seed 0) at 16 x 24, batch 1, through the
    full-width contrast net (JAX-initialised weights): the reference-style
    views fused on the host equal the fused path within 1e-4."""
    variables = random_jax_variables(jax_build_model("contrast"), (1, 32, 32, 3), seed=11)
    tmodel = port_model_from_jax(variables)
    h0, w0, b = 16, 24, 1
    views, label = bench.cam_inputs(np.random.RandomState(0), b, h0, w0, SCALES)
    assert [v.shape for v in views] == [(b, 2, round(h0 * s), round(w0 * s), 3) for s in SCALES]
    tviews = tuple(torch.from_numpy(v.transpose(0, 1, 4, 2, 3).copy()) for v in views)
    fused = tcam.make_fused_msf_fn(tmodel, (h0, w0))(tviews, torch.from_numpy(label)).numpy()
    assert fused.shape == (b, 20, h0, w0)
    with torch.inference_mode():
        cams = [bench.reference_style_view(tmodel, v[0, f][None], (h0, w0))[0].numpy()
                for v in tviews for f in range(2)]
    got = bench.host_fuse(cams, label[0].reshape(20, 1, 1))
    np.testing.assert_allclose(got, fused[0], rtol=0, atol=1e-4)
