"""The port's spans and counters (utils/profiling.py) on the CPU, at tiny
sizes and full widths: off, they never enter the profiler and count
nothing; under `torch.profiler`, CAM inference and a training step show one
range per layer boundary, the bucketing's pixel counters read the
hand-computed sums, and the results are bit-identical either way."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wseg_tpu_torch.infer.cam import CamInferencer
from wseg_tpu_torch.models import build_model
from wseg_tpu_torch.models.layers import Dropout2d
from wseg_tpu_torch.train.contrast import make_train_step
from wseg_tpu_torch.train.optim import PolySGD, param_groups
from wseg_tpu_torch.utils import profiling

SCALES = (0.5, 1.0, 1.5, 2.0)
SIZES = [(27, 37), (33, 22)]
BUCKET = 64


def _model():
    return build_model("contrast", device="cpu", generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def model():
    return _model()


def _items():
    rng = np.random.RandomState(0)
    items = []
    for i, (h, w) in enumerate(SIZES):
        views = []
        for s in SCALES:
            v = rng.randn(round(h * s), round(w * s), 3).astype(np.float32)
            views += [v, v[:, ::-1].copy()]
        label = np.zeros(20, np.float32)
        label[[i, 9 + i]] = 1.0
        items.append((views, label, (h, w)))
    return items


def _counts(prof) -> dict:
    return {e.key[len(profiling.PREFIX):]: e.count for e in prof.key_averages()
            if e.key.startswith(profiling.PREFIX)}


def _recorded(fn):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _counts(prof), dict(profiling.counters)


def _raise(*args, **kwargs):
    raise AssertionError("a span entered the profiler with no profiler recording")


def test_span_and_count_are_off_without_a_profiler(model, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    profiling.reset()
    with profiling.span("x"):
        profiling.count("x", 3)
    CamInferencer(model, scales=SCALES, bucket=BUCKET).infer_batch(_items()[:1])
    assert profiling.counters == {}


def test_infer_batch_ranges_counters_and_bit_identity(model):
    items = _items()
    # the batch's scale-2 views (4 x 128 x 128 px) run as two chunks, the others as one
    inferencer = CamInferencer(model, scales=SCALES, bucket=BUCKET, max_view_px=2 * 128 * 128)
    off = inferencer.infer_batch(items)
    assert profiling.counters == {}
    on, ranges, counters = _recorded(lambda: inferencer.infer_batch(items))
    chunks = len(SCALES) + 1
    assert ranges == {"cam.batch": 1, "cam.assemble": 4, "cam.upsample": 4, "cam.fuse": 2,
                      "cam.h2d": chunks, "cam.forward": chunks, "model.trunk": chunks,
                      "model.pcm": chunks}
    valid = view = 0
    for si in range(len(SCALES)):
        hw = [it[0][2 * si].shape[:2] for it in items]
        valid += sum(2 * h * w for h, w in hw)
        ph = -(-max(h for h, _ in hw) // BUCKET) * BUCKET
        pw = -(-max(w for _, w in hw) // BUCKET) * BUCKET
        view += 2 * len(items) * ph * pw
    # b6 and b7's dilation-4 convs reach K2's rule in every trunk forward; on
    # the CPU none runs on K2
    assert counters == {"cam.valid_px": valid, "cam.view_px": view,
                        "conv.dil4_calls": 2 * chunks}
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a, b)


def _step(model):
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.rate = 0.0
    opt = PolySGD(param_groups(model), 0.01, 5e-4, 100)
    step = make_train_step(model, opt, 0.2, low_res=24)
    img = torch.from_numpy(np.random.RandomState(1).rand(1, 3, 48, 48).astype(np.float32))
    label = torch.zeros(1, 20)
    label[0, 3] = label[0, 7] = 1
    return step(img, label)


def test_train_step_ranges_and_bit_identity():
    off_model, on_model = _model(), _model()
    off = _step(off_model)
    on, ranges, counters = _recorded(lambda: _step(on_model))
    assert {k: v for k, v in ranges.items() if k.startswith("train.")} == {
        "train.step": 1, "train.forward": 1, "train.losses": 1, "train.backward": 1,
        "train.optimizer": 1}
    assert ranges["model.trunk"] == ranges["model.pcm"] == 2
    assert counters == {"conv.dil4_calls": 4}  # b6 and b7 at both views, none on K2 (CPU)
    assert on.keys() == off.keys() and torch.isfinite(on["loss"])
    for k in on:
        assert torch.equal(on[k], off[k]), k
    for (name, a), b in zip(on_model.named_parameters(), off_model.parameters()):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def seg_trainer():
    from wseg_tpu_torch.seg.config import EXPERIMENTS
    from wseg_tpu_torch.train.seg import build_seg_trainer

    return build_seg_trainer(EXPERIMENTS["SEAM_deeplabv1_resnet38"], torch.device("cpu"), 0)


def _seg_batch():
    g = torch.Generator().manual_seed(2)
    label = torch.randint(0, 21, (1, 16, 24), generator=g)
    label[:, :, 20:] = 255
    return torch.randn(1, 3, 16, 24, generator=g), label


def test_seg_step_ranges_and_bn_counters(seg_trainer):
    from wseg_tpu_torch.models.layers import BatchNorm2d

    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
             for m in seg_trainer.model.modules() if isinstance(m, BatchNorm2d)]
    try:
        out, ranges, counters = _recorded(lambda: seg_trainer.step(*_seg_batch()))
    finally:
        for h in hooks:
            h.remove()
    assert torch.isfinite(out["loss"])
    assert {k: v for k, v in ranges.items() if k.startswith("seg.")} == {
        "seg.step": 1, "seg.forward": 1, "seg.backbone": 1, "seg.head": 1, "seg.loss": 1,
        "seg.backward": 1, "seg.optimizer": 1}
    # 37 trunk BNs and the head's two, all in batch-statistics mode
    assert ranges["bn.train"] == len(seen) == 39
    assert counters == {"bn.train_calls": 39, "conv.dil4_calls": 2,
                        "bn.train_bytes": sum(2 * x.numel() * x.element_size() for x in seen)}


def test_frozen_bn_counts_nothing(model):
    x = torch.randn(1, 3, 24, 32)
    _, ranges, counters = _recorded(lambda: model(x))
    assert "bn.train" not in ranges
    assert not any(k.startswith("bn.") for k in counters)


def test_seg_step_counts_nothing_outside_a_recording(seg_trainer):
    profiling.reset()
    seg_trainer.step(*_seg_batch())
    assert profiling.counters == {}
