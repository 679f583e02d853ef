"""Data parallelism of the port (wseg_tpu_torch/parallel/), the light cases,
on gloo CPU ranks spawned over a file store (parallel/launch.py; every
spawn has its own timeout): W ranks at global batch B compute what one
process computes at batch B.

* global-batch BN at 4 ranks against one process and against the JAX
  package's BN on a 4-device mesh (tests/test_seg.py's setup);
* the three trainers' losses at 2 and 4 ranks against one process, on
  outputs whose per-rank label and valid-pixel counts differ, and at 2
  ranks against the JAX package's losses on a 2-device mesh;
* pcm_spatial at 4 ranks against the JAX package's on a 4-device mesh and
  against ops/pcm.py;
* the loader's rows, the gcd rule, seg_test's mIoU reduction, ranks that
  join from torchrun's environment, and a rank that hangs.
Each test states its tolerance."""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wseg_tpu_torch.data.loader import DataLoader
from wseg_tpu_torch.parallel.launch import spawn

import torch_dp_workers as workers

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 120.0  # seconds a spawn may take: a hang fails the test, never the suite


def run(tmp_path, world, calls, name="spawn", timeout=TIMEOUT):
    return spawn("torch_dp_workers:many", world, tmp_path / name, dict(calls=calls),
                 timeout=timeout, pythonpath=[TESTS])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# inputs, made from a seed with numpy


def bn_inputs():
    """tests/test_seg.py:test_global_batch_bn_is_sync_bn's x (8, 4, 4, 4) NHWC,
    as NCHW, and a random loss weighting of the output."""
    x = np.random.RandomState(0).randn(8, 4, 4, 4).astype(np.float32)
    g = np.random.RandomState(1).randn(8, 4, 4, 4).astype(np.float32)
    return x.transpose(0, 3, 1, 2).copy(), g


def loss_keys():
    """The JAX package's keys of the two intra-view NCE draws."""
    return jax.random.split(jax.random.PRNGKey(9))


def loss_inputs():
    """Global batch 4 of model outputs for the three losses. Sample i has
    i + 1 classes, affinity label densities that grow with i and 255 on a
    share of its pixels that grows with i, so no two ranks' label counts or
    valid-pixel counts agree. The intra-view NCE's uniforms `us` are the
    JAX package's draws from loss_keys() at the global M."""
    rng = np.random.RandomState(8)
    n, hi, low = 4, 64, 32

    def outputs(size):
        s8 = size // 8
        return (rng.randn(n, 21, size, size).astype(np.float32),
                rng.randn(n, 21, size, size).astype(np.float32),
                np.maximum(rng.randn(n, 128, s8, s8), 0).astype(np.float32),
                rng.randn(n, 21, s8, s8).astype(np.float32))

    out1, out2 = outputs(hi), outputs(low)
    label21 = np.zeros((n, 21), np.float32)
    label21[:, 0] = 1
    for i in range(n):
        label21[i, rng.choice(np.arange(1, 21), i + 1, replace=False)] = 1
    m = n * (low // 8) ** 2
    contrast = dict(out1=out1, out2=out2, label21=label21, low_res=low,
                    us=tuple(np.array(jax.random.uniform(k, (m,))) for k in loss_keys()))
    d, p = 9, 40
    dens = np.linspace(0.1, 0.7, n)[:, None, None]
    affinity = dict(aff=rng.uniform(0.01, 0.99, (n, d, p)).astype(np.float32),
                    **{k: (rng.rand(n, d, p) < dens * s).astype(np.float32)
                       for k, s in (("bg", 1.0), ("fg", 0.5), ("neg", 0.8))})
    labels = rng.randint(0, 21, (n, 9, 13))
    labels[rng.rand(n, 9, 13) < np.linspace(0.0, 0.9, n)[:, None, None]] = 255
    seg = dict(logits=(rng.randn(n, 21, 9, 13) * 3).astype(np.float32), labels=labels)
    return dict(contrast=contrast, affinity=affinity, seg=seg)


def pcm_inputs():
    """tests/test_spatial_pcm.py's shapes, flattened: cam (1, 256, 21), f
    (1, 256, 48)."""
    rng = np.random.RandomState(0)
    f = rng.randn(1, 16, 16, 48).astype(np.float32)
    cam = rng.rand(1, 16, 16, 21).astype(np.float32)
    return cam.reshape(1, 256, 21), f.reshape(1, 256, 48)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """One 4-rank spawn: BN, the losses, pcm_spatial and the gcd rule at
    batches 6 and 8."""
    x, g = bn_inputs()
    cam, f = pcm_inputs()
    calls = [("bn", dict(x=x, g=g)), ("losses", loss_inputs()),
             ("pcm_spatial", dict(cam=cam, f=f)), ("gcd_rule", dict(batch_size=6)),
             ("gcd_rule", dict(batch_size=8))]
    return run(tmp_path_factory.mktemp("four"), 4, calls)


def miou_inputs(root):
    """5 predicted and ground-truth pngs of 3 sizes (255 on some pixels)."""
    from PIL import Image

    rng = np.random.RandomState(4)
    pred, gt = root / "pred", root / "gt"
    pred.mkdir()
    gt.mkdir()
    names = [f"im{i}" for i in range(5)]
    for i, name in enumerate(names):
        shape = [(20, 30), (24, 24), (16, 40)][i % 3]
        g = rng.choice([0, 3, 8, 15, 255], size=shape).astype(np.uint8)
        p = np.where(rng.rand(*shape) < 0.7, g, rng.choice([0, 3, 8], size=shape)).astype(np.uint8)
        Image.fromarray(g).save(gt / f"{name}.png")
        Image.fromarray(np.where(g == 255, 0, p).astype(np.uint8)).save(pred / f"{name}.png")
    return dict(predict_dir=str(pred), gt_dir=str(gt), names=names)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """One 2-rank spawn: the losses and the mIoU of 5 images."""
    root = tmp_path_factory.mktemp("two")
    return run(root, 2, [("losses", loss_inputs()), ("miou", miou_inputs(root))])


# ---------------------------------------------------------------------------
# global-batch BN


def test_bn_matches_one_process_at_4_ranks(four):
    """The output rows, the running statistics, the weight and bias
    gradients (summed over the ranks' shares) and the input gradient rows
    against one process (F.batch_norm) at the same batch of 8: within 2e-6
    of each one's largest entry (the global-moment E[x^2] - E[x]^2 against
    F.batch_norm's arithmetic; measured <= 3.5e-7)."""
    x, g = bn_inputs()
    want = workers.bn(None, x, g)
    got = [r[0] for r in four]
    for key in ("out", "gx"):
        assert _rel(torch.cat([r[key] for r in got]), want[key]) <= 2e-6, key
    for key in ("gw", "gb"):
        assert _rel(sum(r[key] for r in got), want[key]) <= 2e-6, key
    for key in ("running_mean", "running_var"):
        for r in got:
            assert _rel(r[key], want[key]) <= 2e-6, key
    assert float(want["gx"].abs().max()) > 0.1  # the input gradient is not trivially 0


def test_bn_matches_jax_on_a_4_device_mesh(four):
    """Against the JAX package's BatchNorm2d under jit with the batch sharded
    over 4 virtual devices (tests/test_seg.py:94-123): the output within
    1e-5 and the running statistics within 1e-6, that test's tolerances."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wseg_tpu.models.layers import BatchNorm2d
    from wseg_tpu.parallel.mesh import make_mesh

    x, _ = bn_inputs()
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    bn = BatchNorm2d(4, frozen=False, momentum=0.1)
    variables = bn.init(jax.random.PRNGKey(0), x_nhwc)

    def fwd(v, x):
        out, new = bn.apply(v, x, use_running_average=False, mutable=["batch_stats"])
        return out, new["batch_stats"]

    mesh = make_mesh(jax.devices()[:4])
    out, stats = jax.jit(fwd)(jax.device_put(variables, NamedSharding(mesh, P())),
                              jax.device_put(x_nhwc, NamedSharding(mesh, P("data"))))
    got = [r[0] for r in four]
    np.testing.assert_allclose(torch.cat([r["out"] for r in got]).permute(0, 2, 3, 1).numpy(),
                               np.asarray(out), atol=1e-5)
    for r in got:
        np.testing.assert_allclose(r["running_mean"].numpy(), np.asarray(stats["mean"]),
                                   atol=1e-6)
        np.testing.assert_allclose(r["running_var"].numpy(), np.asarray(stats["var"]),
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the losses


def _rows_of_inputs(inputs, rows):
    """loss_inputs() cut to the samples `rows` (the intra-view keys to their
    pixels)."""
    c = inputs["contrast"]
    px = (c["low_res"] // 8) ** 2
    return dict(contrast=dict(out1=tuple(o[rows] for o in c["out1"]),
                              out2=tuple(o[rows] for o in c["out2"]),
                              label21=c["label21"][rows], low_res=c["low_res"],
                              us=tuple(u[rows.start * px:rows.stop * px] for u in c["us"])),
                affinity={k: v[rows] for k, v in inputs["affinity"].items()},
                seg={k: v[rows] for k, v in inputs["seg"].items()})


@pytest.mark.parametrize("world", [2, 4])
def test_losses_match_one_process(two, four, world):
    """contrast_losses, affinity_losses and cross_entropy_ignore with a group:
    every rank's every metric within 1e-6 relative of one process's at the
    same global batch, and each rank's gradient with respect to its output
    rows, divided by W (the steps average over the ranks), within 1e-5 of
    the largest entry of the one-process gradient (measured: metrics <=
    1.3e-7, gradients equal). The mean of per-rank
    losses is more than 1% off the global one for each of the three, so
    the inputs tell global normalisers from per-rank ones."""
    inputs = loss_inputs()
    want = workers.losses(None, **inputs)
    got = [r[0] for r in two] if world == 2 else [r[1] for r in four]
    for r in got:
        for kind in ("contrast", "affinity"):
            for key in want[kind]:
                assert _rel(r[kind][key], want[kind][key]) <= 1e-6, (kind, key)
        assert _rel(r["seg"], want["seg"]) <= 1e-6
    for i, w in enumerate(want["contrast_grads"]):
        if w is None:  # an output the losses use only detached
            assert all(r["contrast_grads"][i] is None for r in got), i
        else:
            assert _rel(torch.cat([r["contrast_grads"][i] for r in got]) / world, w) <= 1e-5, i
    for key in ("affinity_grad", "seg_grad"):
        assert _rel(torch.cat([r[key] for r in got]) / world, want[key]) <= 1e-5, key

    n = inputs["seg"]["labels"].shape[0]
    per_rank = [workers.losses(None, **_rows_of_inputs(inputs, slice(r * n // world,
                                                                     (r + 1) * n // world)))
                for r in range(world)]
    for kind in ("contrast", "affinity"):
        mean = np.mean([float(m[kind]["loss"]) for m in per_rank])
        assert abs(mean - float(want[kind]["loss"])) > 1e-2 * float(want[kind]["loss"]), kind
    mean = np.mean([float(m["seg"]) for m in per_rank])
    assert abs(mean - float(want["seg"])) > 1e-2 * float(want["seg"])


def _jax_losses_on_mesh(inputs):
    """The JAX package's contrast_losses, affinity_losses and
    cross_entropy_ignore, each jitted with its value and its gradient with
    respect to the outputs, the batch sharded over a 2-device mesh (as
    tests/test_cli_train_dp.py's trainers); gradients NCHW as the port's."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from wseg_tpu.parallel.mesh import make_mesh
    from wseg_tpu.train.affinity import affinity_losses
    from wseg_tpu.train.contrast import contrast_losses
    from wseg_tpu.train.seg import cross_entropy_ignore

    rows = NamedSharding(make_mesh(jax.devices()[:2]), P("data"))

    def put(a, nhwc=False):
        return jax.device_put(jnp.asarray(a.transpose(0, 2, 3, 1) if nhwc else a), rows)

    def nchw(g):
        return np.asarray(g).transpose(0, 3, 1, 2)

    c, a, s = inputs["contrast"], inputs["affinity"], inputs["seg"]
    keys = tuple(loss_keys())

    def contrast(o1, o2, label21):
        mets = contrast_losses(o1, o2, label21, keys, 0.2, low_res=c["low_res"])
        return mets["loss"], mets

    (_, cm), (g1, g2) = jax.jit(jax.value_and_grad(contrast, argnums=(0, 1), has_aux=True))(
        tuple(put(o, True) for o in c["out1"]), tuple(put(o, True) for o in c["out2"]),
        put(c["label21"]))

    def affinity(aff, *labels):
        mets = affinity_losses(aff, *labels)
        return mets["loss"], mets

    (_, am), ag = jax.jit(jax.value_and_grad(affinity, has_aux=True))(
        *(put(a[k]) for k in ("aff", "bg", "fg", "neg")))
    sl, sg = jax.jit(jax.value_and_grad(cross_entropy_ignore))(put(s["logits"], True),
                                                               put(s["labels"]))
    return dict(contrast=cm, contrast_grads=[nchw(g) for g in tuple(g1) + tuple(g2)],
                affinity=am, affinity_grad=np.asarray(ag), seg=sl, seg_grad=nchw(sg))


def test_losses_match_jax_on_a_2_device_mesh(two):
    """The three losses on 2 ranks against the JAX package's on a 2-device
    mesh (the batch sharded), on loss_inputs(): every rank's every metric
    within tests/test_torch_losses.py's 1e-5 relative for stage 1 and
    tests/test_torch_aff_train.py's 1e-6 for stage 2 and stage 3, and the
    ranks' gradients with respect to their output rows, divided by W, within
    1e-5 of the largest entry of JAX's (measured: metrics <= 1.3e-7,
    gradients <= 5.5e-7); an output the port uses only detached has JAX
    gradient 0."""
    want = _jax_losses_on_mesh(loss_inputs())
    got = [r[0] for r in two]
    for r in got:
        assert r["contrast"].keys() == want["contrast"].keys()
        for key in want["contrast"]:
            assert _rel(r["contrast"][key], want["contrast"][key]) <= 1e-5, key
        assert r["affinity"].keys() == want["affinity"].keys()
        for key in want["affinity"]:
            assert _rel(r["affinity"][key], want["affinity"][key]) <= 1e-6, key
        assert _rel(r["seg"], want["seg"]) <= 1e-6
    for i, w in enumerate(want["contrast_grads"]):
        if got[0]["contrast_grads"][i] is None:
            assert not np.any(w) and all(r["contrast_grads"][i] is None for r in got), i
        else:
            assert _rel(torch.cat([r["contrast_grads"][i] for r in got]) / 2, w) <= 1e-5, i
    for key in ("affinity_grad", "seg_grad"):
        assert _rel(torch.cat([r[key] for r in got]) / 2, want[key]) <= 1e-5, key


# ---------------------------------------------------------------------------
# pcm_spatial


def test_pcm_spatial_matches_jax_and_dense_pcm(four):
    """The ranks' row blocks of pcm_spatial, concatenated, against the JAX
    package's pcm_spatial on a 4-device `space` mesh and against the port's
    dense pcm_flat (ops/pcm.py), rtol 1e-4 / atol 1e-5
    (tests/test_spatial_pcm.py's)."""
    from wseg_tpu.parallel.mesh import make_mesh
    from wseg_tpu.parallel.spatial import pcm_spatial as jax_pcm_spatial
    from wseg_tpu_torch.ops.pcm import pcm_flat

    cam, f = pcm_inputs()
    got = torch.cat([r[2] for r in four], dim=1).numpy()
    mesh = make_mesh(jax.devices()[:4], axis_name="space")
    want_jax = np.asarray(jax.jit(lambda c, x: jax_pcm_spatial(c, x, mesh, axis="space"))(
        jnp.asarray(cam), jnp.asarray(f)))
    want = pcm_flat(torch.from_numpy(cam), torch.from_numpy(f)).numpy()
    assert got.shape == (1, 256, 21)
    np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the loader, the gcd rule, a hang


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.array([i]),)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("world", [2, 4])
def test_loader_rows_make_the_one_process_epoch(shuffle, world):
    """Every rank walks the same global batches (seed, set_epoch) and takes
    its rows: the ranks' rows, in rank order, are the one-process batches,
    batch for batch, for two epochs."""
    one = DataLoader(_Items(26), 8, num_workers=2, seed=5, shuffle=shuffle)
    ranks = [DataLoader(_Items(26), 8, num_workers=2, seed=5, shuffle=shuffle, shard=(r, world))
             for r in range(world)]
    for epoch in (0, 1):
        for loader in [one] + ranks:
            loader.set_epoch(epoch)
        want = [b[0][:, 0].tolist() for b in one]
        got = [sum((b[0][:, 0].tolist() for b in parts), [])
               for parts in zip(*(list(loader) for loader in ranks))]
        assert got == want and len(want) == 3
    with pytest.raises(ValueError):
        DataLoader(_Items(26), 6, shard=(0, 4))


def test_gcd_rule(four):
    """Batch 6 on 4 ranks trains on the first gcd = 2, with the JAX
    package's warning printed once; batch 8 trains on all 4, silently."""
    six = [r[3] for r in four]
    assert [r["trains"] for r in six] == [True, True, False, False]
    assert [r["size"] for r in six] == [2, 2, 0, 0]
    assert [r["total"] for r in six[:2]] == [2.0, 2.0]
    assert "WARNING: batch_size 6 is not divisible by the 4 ranks" in six[0]["printed"]
    assert "only 2 rank(s)" in six[0]["printed"]
    assert not any(r["printed"] for r in six[1:])
    eight = [r[4] for r in four]
    assert all(r["trains"] and r["size"] == 4 and r["total"] == 4.0 for r in eight)
    assert not any(r["printed"] for r in eight)


def test_miou_over_2_ranks_equals_one_process(two, tmp_path_factory):
    """seg_test's eval with a group: each rank reads its block of 5 images (2
    and 3) and the confusion matrices are summed over the ranks, so every
    rank's per-class IoU and mIoU equal one process's over all 5, exactly."""
    want = workers.miou(None, **miou_inputs(tmp_path_factory.mktemp("miou")))
    assert want["mIoU"] > 0
    for r in two:
        assert r[1] == want


def test_torchrun_environment_joins_the_group(tmp_path):
    """Ranks started as torchrun starts them (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT: parallel/launch.py:spawn(torchrun=True)) join
    through parallel/mesh.py:joined, as the CLIs do: gloo for the CPU, the
    environment's rank and world size, a bare cuda mapped to the
    LOCAL_RANK'th card. At global batch 4 both ranks train and sum over
    both; at batch 3 the gcd rule leaves rank 0 to train alone, with the
    warning, and rank 1 ends at once. Each rank's group is gone when its
    `with` block ends."""
    ranks = spawn("torch_dp_workers:torchrun_join", 2, tmp_path / "ranks", dict(batches=[4, 3]),
                  timeout=TIMEOUT, pythonpath=[TESTS], torchrun=True)
    for r, got in enumerate(ranks):
        assert (got["backend"], got["rank"], got["size"]) == ("gloo", r, 2)
        assert got["cuda"] == f"cuda:{r}"
        assert got["steps"][0] == dict(trains=True, size=2, sum=[2.0, 1.0])
        assert got["left"]
    assert ranks[0]["steps"][1] == dict(trains=True, size=1, sum=[1.0, 0.0])
    assert ranks[1]["steps"][1] == dict(trains=False, size=0, sum=None)
    assert "WARNING: batch_size 3 is not divisible by the 2 ranks" in ranks[0]["printed"]
    assert not ranks[1]["printed"]


def test_a_hanging_rank_fails_the_spawn_in_bounded_time(tmp_path):
    """Rank 1 sleeps for 10 minutes before a barrier; with a 5 s group
    timeout the spawn raises within a minute, naming the failed rank."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0"):
        spawn("torch_dp_workers:hang", 2, tmp_path / "hang", dict(seconds=600), timeout=5.0,
              pythonpath=[TESTS])
    assert time.monotonic() - t0 < 60
