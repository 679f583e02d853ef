"""Weights in and out of the port.

* `state_dict_from_jax`: the JAX package's (params, batch_stats) trees as
  numpy arrays -> a state_dict with the reference's key names, conv kernels
  transposed HWIO -> OIHW. It inverts the JAX package's
  `convert_torch_state_dict` (wseg_tpu/utils/checkpoint.py:61-114).
  `seg_state_dict_from_jax` does the same for the stage-3 nets, whose trunk
  and head namespaces stay apart (`backbone/resnet38/b2/...` ->
  `backbone.b2...`, `backbone/layer3_4/conv2` -> `backbone.layer3.4.conv2`).
* `load_weights`: a reference `.pth` state_dict, a JAX `.ckpt` file (flax
  msgpack of {'params', 'batch_stats'}), decoded here without flax, or the
  ImageNet ResNet-38 MXNet `.params` (`state_dict_from_mxnet`, read with
  numpy: wseg_tpu/utils/checkpoint.py:125-277).
  `backbone_weights`: a stage-1 file as a stage-3 backbone (seg_train.py:
  125-144 of the JAX package).
* `merge_state_dict`: loaded weights laid over a model's own, keeping its
  init where a key is missing or its shape differs (a stage-1 net's weights
  into AffinityNet).
* `save_weights` / `save_train_state` / `load_train_state`: the port's own
  files, written with torch.save: a state_dict with the reference's keys
  (readable by `load_weights` and by the JAX package's `.pth` import), and a
  resumable training state (model, optimizer, step, generator).

Writes are atomic: a temp file in the target's directory, fsynced, then
`os.replace`d over the target, so a kill mid-write never truncates the only
resume state. Stale `.<name>.tmp.*` siblings that a killed writer left
behind are removed first.
"""

from __future__ import annotations

import glob
import os
import re
from collections.abc import Mapping

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, path: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _module_key(path: tuple) -> str:
    # the JAX ContrastNet nests its trunk under "backbone"; the reference's
    # (and the port's) trunk blocks sit at the top level
    mods = path[1:-1] if path[0] == "backbone" else path[:-1]
    return ".".join(mods)


def _from_jax(params: Mapping, batch_stats: Mapping, module_key) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        arr = np.array(val, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            out[module_key(path) + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf in _BN_LEAVES:
            out[module_key(path) + "." + _BN_LEAVES[leaf]] = torch.from_numpy(arr)
        else:
            raise KeyError(f"unmapped JAX param {'/'.join(path)}")
    for path, val in _leaves(batch_stats):
        leaf = path[-1]
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"unmapped JAX batch stat {'/'.join(path)}")
        out[module_key(path) + "." + _STAT_LEAVES[leaf]] = torch.from_numpy(
            np.array(val, dtype=np.float32))
    return out


def state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """(params, batch_stats) trees of numpy arrays -> state_dict."""
    return _from_jax(params, batch_stats, _module_key)


# the JAX DilatedResNet's deep-base stem -> the reference's Sequential indices
_SEG_STEM = {"conv1_0": "conv1.0", "conv1_bn0": "conv1.1", "conv1_1": "conv1.3",
             "conv1_bn1": "conv1.4", "conv1_2": "conv1.6", "bn1": "bn1"}
_SEG_BLOCK = {"conv1": "conv1", "bn1": "bn1", "conv2": "conv2", "bn2": "bn2",
              "conv3": "conv3", "bn3": "bn3", "downsample_conv": "downsample.0",
              "downsample_bn": "downsample.1"}
_SEG_HEAD = ("conv_fov", "bn_fov", "conv_fov2", "bn_fov2", "cls_conv")


def _seg_module_key(path: tuple) -> str:
    mods = path[:-1]
    key = None
    if mods[:2] == ("backbone", "resnet38") and len(mods) > 2:
        key = ".".join(("backbone",) + mods[2:])
    elif mods[0] == "backbone" and len(mods) == 2 and mods[1] in _SEG_STEM:
        key = "backbone." + _SEG_STEM[mods[1]]
    elif mods[0] == "backbone" and len(mods) == 3 and mods[2] in _SEG_BLOCK:
        m = re.fullmatch(r"(layer[1-4])_(\d+)", mods[1])
        if m:
            key = f"backbone.{m[1]}.{m[2]}.{_SEG_BLOCK[mods[2]]}"
    elif mods[0] == "aspp" and len(mods) == 2 and mods[1] in ("branch5_conv", "branch5_bn"):
        key = f"aspp.{mods[1]}"
    elif (mods[0] == "aspp" and len(mods) == 3 and mods[2] in ("conv", "bn")
          and re.fullmatch(r"branch[1-4]|conv_cat", mods[1])):
        key = f"aspp.{mods[1]}.{0 if mods[2] == 'conv' else 1}"
    elif len(mods) == 1 and mods[0] in _SEG_HEAD:
        key = mods[0]
    if key is None:
        raise KeyError(f"unmapped JAX seg-net entry {'/'.join(path)}")
    return key


def seg_state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """The stage-3 nets' (params, batch_stats) trees (DeepLab v1 / v2 on
    ResNet-38 or a dilated ResNet) -> a state_dict with the reference's keys.
    Raises KeyError on any entry it cannot map."""
    return _from_jax(params, batch_stats, _seg_module_key)


# flax.serialization's msgpack ext types (ndarray = 1, npscalar = 3); an ndarray
# is packed as msgpack (shape, dtype name, C-order bytes).
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":  # widen to f32 exactly: bf16 is f32's top half
        u16 = np.frombuffer(buf, np.uint16)
        arr = (u16.astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(buf, np.dtype(dtype_name.decode()))
    return arr.reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def read_flax_msgpack(path: str) -> dict:
    """Decode a file written by flax.serialization.to_bytes into nested dicts
    of numpy arrays. Arrays flax splits into chunks (> 1 GiB) are refused."""
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    for p, v in _leaves(tree):
        if p[-1] == "__msgpack_chunked_array__":
            raise ValueError(f"{path}: chunked arrays are not supported ({'/'.join(p)})")
    return tree


# MXNet `.params` (mxnet `NDArray::Save` list format): uint64 list magic 0x112,
# uint64 reserved, uint64 count, then per array a legacy NDArray record, then
# uint64 name count + (uint64 len, bytes) names. NDArray records:
#   V2 / V3 magic (0xF993FAC9 / 0xF993FACA): int32 stype, uint32 ndim, dims
#     (uint32 for V2, int64 for V3), int32 dev_type, int32 dev_id, int32
#     dtype, raw data;
#   legacy (no magic): uint32 ndim, uint32 dims, context, dtype, raw data.
_MX_LIST_MAGIC = 0x112
_ND_V2_MAGIC = 0xF993FAC9
_ND_V3_MAGIC = 0xF993FACA
_MX_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8, 4: np.int32}


def _read_mx_ndarray(buf: bytes, off: int) -> tuple[np.ndarray, int]:
    def scalar(dtype, o):
        return int(np.frombuffer(buf, dtype, 1, o)[0]), o + np.dtype(dtype).itemsize

    magic, off2 = scalar(np.uint32, off)
    if magic in (_ND_V2_MAGIC, _ND_V3_MAGIC):
        off = off2
        stype, off = scalar(np.int32, off)
        if stype not in (-1, 0):
            raise ValueError(f"unsupported mxnet storage type {stype} (only dense)")
        ndim, off = scalar(np.uint32, off)
        dim_type = np.int64 if magic == _ND_V3_MAGIC else np.uint32
    else:  # a legacy record: the magic was the ndim
        ndim, off = magic, off2
        if ndim > 8:
            raise ValueError(f"unparseable mxnet record at offset {off - 4}")
        dim_type = np.uint32
    dims = []
    for _ in range(ndim):
        d, off = scalar(dim_type, off)
        dims.append(d)
    off += 8  # dev_type, dev_id
    dtype_flag, off = scalar(np.int32, off)
    dtype = np.dtype(_MX_DTYPES[dtype_flag])
    count = int(np.prod(dims)) if dims else 1
    arr = np.frombuffer(buf, dtype, count, off).reshape(dims).copy()
    return arr, off + count * dtype.itemsize


def read_mxnet_params(path: str) -> dict[str, np.ndarray]:
    """A `mxnet.nd.save` file as {name: array}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, _, count = (int(v) for v in np.frombuffer(buf, np.uint64, 3, 0))
    if magic != _MX_LIST_MAGIC:
        raise ValueError(f"{path}: not an mxnet NDArray list (magic {magic:#x})")
    off = 24
    arrays = []
    for _ in range(count):
        arr, off = _read_mx_ndarray(buf, off)
        arrays.append(arr)
    n_names = int(np.frombuffer(buf, np.uint64, 1, off)[0])
    off += 8
    names = []
    for _ in range(n_names):
        ln = int(np.frombuffer(buf, np.uint64, 1, off)[0])
        off += 8
        names.append(buf[off:off + ln].decode())
        off += ln
    if len(names) != len(arrays):
        raise ValueError(f"{path}: {len(names)} names for {len(arrays)} arrays")
    return dict(zip(names, arrays))


_MX_BN_LEAVES = {"beta": "bias", "gamma": "weight", "mean": "running_mean",
                 "var": "running_var"}


def _mxnet_key(key: str) -> str | None:
    """An MXNet ResNet-38 name ('arg:res3a_branch2a_weight',
    'aux:bn3a_branch2a_moving_mean', 'arg:bn7_gamma', ...) as the port's
    state_dict key, the renaming of the reference's convert_mxnet_to_torch
    (network/resnet38d.py:216-264); None for the ImageNet classifier."""
    toks = key.split(":", 1)[-1].split("_")
    if "conv1a" in toks[0]:
        return "conv1a.weight"
    if "linear1000" in toks[0]:
        return None
    if len(toks) >= 2 and "branch" in toks[1]:
        stage = toks[0]  # res3a / bn3a -> b3; res4b1 / bn4b1 -> b4_1
        block = "b" + stage[-2] if stage[-1] == "a" else "b" + stage[-3] + "_" + stage[-1]
        if "res" in stage or "conv" in stage[:4]:
            return f"{block}.conv_{toks[1]}.weight"
        return f"{block}.bn_{toks[1]}.{_MX_BN_LEAVES[toks[-1]]}"
    return f"bn7.{_MX_BN_LEAVES[toks[-1]]}"


def state_dict_from_mxnet(path: str) -> dict[str, torch.Tensor]:
    """The ImageNet-pretrained ResNet-38 `.params` as a trunk state_dict
    (the JAX package's convert_mxnet_params, with conv kernels kept OIHW)."""
    out = {}
    for key, arr in read_mxnet_params(path).items():
        name = _mxnet_key(key)
        if name is not None:
            out[name] = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
    return out


def load_weights(path: str, seg: bool = False) -> dict[str, torch.Tensor]:
    """A state_dict from a reference `.pth`, a JAX `.ckpt` (of a stage-3 net
    with `seg`) or the ImageNet `.params`. BatchNorm's `num_batches_tracked`
    counters are dropped: the port's BN keeps none."""
    if path.endswith(".pth"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if {"model", "optimizer", "generator"} <= state.keys():
            raise ValueError(f"{path} is a training state (save_train_state), not weights: "
                             "resume from it instead")
        return {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    if path.endswith(".ckpt"):
        tree = read_flax_msgpack(path)
        convert = seg_state_dict_from_jax if seg else state_dict_from_jax
        return convert(tree["params"], tree.get("batch_stats", {}))
    if path.endswith(".params"):
        return state_dict_from_mxnet(path)
    raise ValueError(f"unknown weights format (expected .pth, .ckpt or .params): {path}")


STAGE1_HEADS = ("fc8", "fc_proj", "f8_3", "f8_4", "f8_5", "f9")


def backbone_weights(path: str) -> dict[str, torch.Tensor]:
    """A stage-1 file (port or reference `.pth`, JAX `.ckpt`, params only or
    not, or the ImageNet `.params`) as stage-3 backbone entries: keys under `backbone.`, the stage-1
    heads dropped, and the drop reported."""
    out, dropped = {}, set()
    for key, val in load_weights(path).items():
        top = key.split(".")[0]
        if top in STAGE1_HEADS:
            dropped.add(top)
        else:
            out[key if top == "backbone" else "backbone." + key] = val
    print(f"dropped the stage-1 heads {sorted(dropped)} of {path}")
    return out


def merge_state_dict(init: Mapping[str, torch.Tensor], loaded: Mapping[str, torch.Tensor],
                     what: str = "") -> dict[str, torch.Tensor]:
    """`init` with every entry that `loaded` has at the same shape replaced
    by the loaded tensor (in init's dtype); the rest keep their init, as
    `load_state_dict(strict=False)` would if it skipped shape mismatches
    (the JAX package's merge_params). With `what` set, prints how many
    entries matched and warns when none did: a file of another model would
    otherwise "load" silently and train from random init."""
    out, matched = {}, 0
    for key, val in init.items():
        new = loaded.get(key)
        if new is not None and tuple(new.shape) == tuple(val.shape):
            out[key] = new.to(dtype=val.dtype)
            matched += 1
        else:
            out[key] = val
    if what:
        print(f"merged {matched}/{len(init)} {what}")
        if matched == 0 and init:
            import warnings

            warnings.warn(f"no {what} matched the model's state_dict: the file's keys do "
                          "not overlap this model; everything stays at init")
    return out


def _atomic_save(obj, path: str):
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    prefix = os.path.join(dirname, f".{os.path.basename(path)}.tmp.")
    for stale in glob.glob(glob.escape(prefix) + "*"):
        try:
            os.remove(stale)
        except FileNotFoundError:
            pass
    tmp = f"{prefix}{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _cpu_state(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_weights(path: str, model: torch.nn.Module):
    """The model's state_dict (reference key names, CPU tensors) as `.pth`."""
    _atomic_save(_cpu_state(model), path)


def save_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     step: int, generator: torch.Generator):
    """Everything a resumed run needs to continue the same trajectory."""
    _atomic_save({"model": _cpu_state(model), "optimizer": optimizer.state_dict(),
                  "step": int(step), "generator": generator.get_state()}, path)


def load_train_state(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     generator: torch.Generator) -> int:
    """Restore a `save_train_state` file in place; returns its step."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    generator.set_state(state["generator"])
    return state["step"]
