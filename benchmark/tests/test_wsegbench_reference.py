"""The plain reference against the port at a tiny size on the CPU: the net's
forward, one image's multi-scale CAM, the stage-1 losses and a training
step."""

import numpy as np
import torch

from benchmark import traffic, weights
from benchmark.reference import cam as ref_cam
from benchmark.reference import contrast_net, losses
from benchmark.reference import train as ref_train

CPU = torch.device("cpu")
SCALES = (0.5, 1.0, 1.5, 2.0)


def port_model(params):
    from wseg_tpu_torch.models import build_model

    model = build_model("contrast", device=CPU)
    model.load_state_dict(params, strict=True)
    return model


def test_the_forward_matches():
    p = weights.contrast(1, CPU)
    model = port_model(p).eval()
    x = traffic.crops(torch.Generator().manual_seed(2), 2, 48, CPU).permute(0, 3, 1, 2)
    with torch.no_grad():
        cam, rv = model(x, raw_cam=True)
        want_cam, want_rv = contrast_net.forward(p, x, raw_cam=True)
    torch.testing.assert_close(cam, want_cam, rtol=1e-4, atol=1e-4 * float(want_cam.abs().max()))
    torch.testing.assert_close(rv, want_rv, rtol=1e-4, atol=1e-4 * float(want_rv.abs().max()))


def test_one_images_msf_cam_matches():
    from PIL import Image

    from wseg_tpu_torch.data import transforms as T
    from wseg_tpu_torch.infer.cam import CamInferencer

    p = weights.contrast(3, CPU)
    img = traffic.image(3, 0, 43, 61)
    label = np.zeros(20, np.float32)
    label[[4, 11]] = 1
    views = [T.Normalize()(v) for v in T.msf_views(Image.fromarray(img), SCALES)]
    got = CamInferencer(port_model(p), bucket=64).infer_one(views, label, img.shape[:2])
    want = ref_cam.msf_cam(p, img, label, SCALES)
    assert np.abs(got - want).max() < 1e-4


def test_the_losses_and_a_step_match():
    from wseg_tpu_torch.train.contrast import contrast_losses, make_train_step
    from wseg_tpu_torch.train.optim import PolySGD, param_groups

    cfg = {"lr": 0.01, "weight_decay": 5e-4, "momentum": 5e-4, "poly_power": 0.9,
           "max_step": 100, "bg_threshold": 0.2, "low_res": 32}
    p = weights.contrast(4, CPU)
    img = traffic.crops(torch.Generator().manual_seed(5), 2, 64, CPU).permute(0, 3, 1, 2)
    label = torch.zeros(2, 20)
    label[0, 3] = label[1, [5, 9]] = 1
    model = port_model(p)
    opt = PolySGD(param_groups(model), cfg["lr"], cfg["weight_decay"], cfg["max_step"],
                  momentum=cfg["momentum"])
    step = make_train_step(model, opt, low_res=32, generator=torch.Generator().manual_seed(6))
    got = step(img, label)["loss"]
    want = ref_train.steps(p, [(img, label)], cfg, torch.Generator().manual_seed(6))
    assert abs(float(got) - float(want["loss"][0])) < 1e-5 * abs(float(got))
    for name, par in model.named_parameters():
        if name in want["change"]:
            change = float(torch.linalg.vector_norm(par.detach() - p[name]))
            assert abs(change - float(want["change"][name])) <= 1e-3 * float(want["change"][name])

    # the losses alone, on the same outputs
    outs = [tuple(t.detach() for t in contrast_net.forward(p, x)) for x in
            (img, contrast_net.up(img, (32, 32)))]
    label21 = torch.cat([torch.ones(2, 1), label], 1)
    us = (torch.rand(2 * 16), torch.rand(2 * 16))
    torch.testing.assert_close(contrast_losses(*outs, label21, us, 0.2, 32)["loss"],
                               losses.stage1_loss(*outs, label21, us, 0.2, 32)["loss"])
