"""The FLOP counter against a count by hand of the same convolutions and
products, and K1's work as the kernel table counts it."""

import pytest

from benchmark import flops
from benchmark.reference import contrast_net

SCALES = (0.5, 1.0, 1.5, 2.0)


def by_hand(h: int, w: int) -> int:
    """2 x MACs of the raw-CAM forward of a view pair per scale: every conv at
    its output size, PCM's two products."""
    total = 0
    for s in SCALES:
        vh, vw = round(h * s), round(w * s)

        def conv(cin, cout, k, oh, ow):
            return 2 * 2 * cin * cout * k * k * oh * ow

        oh, ow = vh, vw
        total += conv(3, 64, 3, oh, ow)
        for _, cin, mid, cout, stride, _, _ in contrast_net.BASIC:
            if stride == 2:
                oh, ow = -(-oh // 2), -(-ow // 2)
            if cin != cout or stride != 1:
                total += conv(cin, cout, 1, oh, ow)
            total += conv(cin, mid, 3, oh, ow) + conv(mid, cout, 3, oh, ow)
        for _, cin, cout, _, _ in contrast_net.BOTTLENECK:
            total += (conv(cin, cout, 1, oh, ow) + conv(cin, cout // 4, 1, oh, ow)
                      + conv(cout // 4, cout // 2, 3, oh, ow) + conv(cout // 2, cout, 1, oh, ow))
        total += (conv(4096, 21, 1, oh, ow) + conv(512, 64, 1, oh, ow)
                  + conv(1024, 128, 1, oh, ow) + conv(195, 192, 1, oh, ow))
        hw = oh * ow
        total += 2 * 2 * hw * hw * 192 + 2 * 2 * hw * hw * 21
    return total


@pytest.mark.parametrize("hw", [(375, 500), (500, 333), (48, 40)])
def test_cam_flops_equal_the_count_by_hand(hw):
    assert flops.cam_image(*hw, SCALES) == by_hand(*hw)


def test_pcm_work_is_the_kernel_tables_count():
    # PERF.md's f32 pair at (2, 12288, 192): 2 x 2 x 12288^2 x (192 + 21)
    ops, nbytes = flops.pcm_work(768, 1024, (1.0,))
    assert ops == 2 * 2 * 12288**2 * (192 + 21)
    assert nbytes == 2 * 12288 * (21 + 192 + 21) * 4


def test_a_training_step_counts_forward_and_backward():
    # cam_image counts a view pair; the step's batch is one crop and its downscale
    fwd = (flops.cam_image(64, 64, (1.0,)) + flops.cam_image(32, 32, (1.0,))) / 2
    step = flops.train_step(1, 64, 32, 0.2)
    # the backward adds up to twice the forward; the frozen conv1a and b2*
    # need no weight gradient and no input gradient
    assert 2 * fwd < step < 3 * fwd
