"""The port must run on a host that has torch and none of JAX: no module of
wseg_tpu_torch, and not chip_smoke.py, may import jax, flax, optax or the JAX
package wseg_tpu. Nor may they import cv2 or PIL at top level: the image
libraries are imported inside the functions that use them."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "wseg_tpu", "cv2", "PIL")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import wseg_tpu_torch
mods = ["wseg_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(wseg_tpu_torch.__path__, "wseg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
assert not any(k == b or k.startswith(b + ".") for k in sys.modules for b in BLOCKED)
print("\n".join(mods))
print(len(mods))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 71  # every module was walked
    for mod in ("seg.config", "seg.backbones", "seg.deeplab", "seg.dataset", "train.seg",
                "cli.seg_train", "cli.seg_test", "utils.visualization", "ops.crf",
                "cli.reproduce", "cli.make_cls_labels", "utils.profiling", "cli.bench",
                "models.seam", "data.segmentation", "seg.xception", "seg.extra_datasets",
                "parallel.mesh", "parallel.spatial", "parallel.launch",
                "cli.dryrun_multichip"):
        assert f"wseg_tpu_torch.{mod}" in out.stdout


def test_blocker_blocks_the_jax_package():
    probe = _PROBE.split("import wseg_tpu_torch")[0] + "import wseg_tpu.utils.registry\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "blocked import of wseg_tpu" in out.stderr
