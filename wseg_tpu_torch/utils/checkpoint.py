"""Weights in and out of the port.

* `state_dict_from_jax`: the JAX package's (params, batch_stats) trees as
  numpy arrays -> a state_dict with the reference's key names, conv kernels
  transposed HWIO -> OIHW. It inverts the JAX package's
  `convert_torch_state_dict` (wseg_tpu/utils/checkpoint.py:61-114).
* `load_weights`: a reference `.pth` state_dict, or a JAX `.ckpt` file (flax
  msgpack of {'params', 'batch_stats'}), decoded here without flax.
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


def state_dict_from_jax(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """(params, batch_stats) trees of numpy arrays -> state_dict."""
    out: dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        arr = np.array(val, dtype=np.float32)
        leaf = path[-1]
        if leaf == "kernel":
            out[_module_key(path) + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf in _BN_LEAVES:
            out[_module_key(path) + "." + _BN_LEAVES[leaf]] = torch.from_numpy(arr)
        else:
            raise KeyError(f"unmapped JAX param {'/'.join(path)}")
    for path, val in _leaves(batch_stats):
        leaf = path[-1]
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"unmapped JAX batch stat {'/'.join(path)}")
        out[_module_key(path) + "." + _STAT_LEAVES[leaf]] = torch.from_numpy(
            np.array(val, dtype=np.float32))
    return out


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


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """A state_dict from a reference `.pth` or a JAX `.ckpt`. BatchNorm's
    `num_batches_tracked` counters are dropped: the port's BN is frozen."""
    if path.endswith(".pth"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if {"model", "optimizer", "generator"} <= state.keys():
            raise ValueError(f"{path} is a training state (save_train_state), not weights: "
                             "resume from it instead")
        return {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
    if path.endswith(".ckpt"):
        tree = read_flax_msgpack(path)
        return state_dict_from_jax(tree["params"], tree.get("batch_stats", {}))
    raise ValueError(f"unknown weights format (expected .pth or .ckpt): {path}")


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
