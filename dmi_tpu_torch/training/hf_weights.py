"""Llama weights in the Hugging Face layout, read from disk without
transformers or safetensors (neither is installed on the card's machine).

A model is named by a local directory or by a hub id ("org/name") that the
HF hub cache holds: `$HF_HUB_CACHE`, else `$HF_HOME/hub`, else
`~/.cache/huggingface/hub`, then `models--{org}--{name}/refs/main` names the
snapshot `snapshots/<rev>/`.  Nothing is downloaded.  The directory holds
`config.json` and the weights as `model.safetensors`, safetensors shards
under `model.safetensors.index.json`, `pytorch_model.bin`, or .bin shards
under `pytorch_model.bin.index.json`, looked for in that order.

The safetensors format is an 8-byte little-endian header length, a JSON
header (per tensor: dtype, shape, [start, end) offsets into the data), then
the raw little-endian bytes.  BF16, F16 and F32 tensors are read as they
are stored; any other dtype is refused by name.  `.bin` files go through
torch.load(map_location="cpu", weights_only=True).
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict

import torch

SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
_WEIGHT_FILES = ("model.safetensors", "model.safetensors.index.json", "pytorch_model.bin",
                 "pytorch_model.bin.index.json")


def hub_cache() -> Path:
    """The HF hub cache directory, as huggingface_hub resolves it."""
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]) / "hub"
    return Path.home() / ".cache" / "huggingface" / "hub"


def model_dir(name: str) -> Path:
    """The local directory of model `name`: the directory itself, or the
    snapshot that the hub cache's refs/main names.  Raises
    FileNotFoundError naming the paths searched."""
    path = Path(name).expanduser()
    if path.is_dir():
        return path
    repo = hub_cache() / ("models--" + name.replace("/", "--"))
    ref = repo / "refs" / "main"
    searched = [str(path), str(ref)]
    if ref.is_file():
        snapshot = repo / "snapshots" / ref.read_text().strip()
        if snapshot.is_dir():
            return snapshot
        searched.append(str(snapshot))
    raise FileNotFoundError(
        f"{name!r}: no local model found (searched {', '.join(searched)}); point "
        "lm_name_or_path at a local HF directory or fill the HF cache (HF_HUB_CACHE, "
        "HF_HOME); nothing is downloaded")


def read_config(directory) -> dict:
    """The parsed config.json of a model directory."""
    with open(Path(directory) / "config.json") as f:
        return json.load(f)


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, on the CPU, in its stored dtype
    (views into one buffer holding the file's data)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        f.readinto(data)
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}; only "
                             f"{', '.join(SAFETENSORS_DTYPES)} are read")
        start, end = info["data_offsets"]
        count = (end - start) // dtype.itemsize
        flat = (torch.frombuffer(data, dtype=dtype, count=count, offset=start) if count
                else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"])
    return out


def _read_shards(directory: Path, index: str, read) -> Dict[str, torch.Tensor]:
    with open(directory / index) as f:
        weight_map = json.load(f)["weight_map"]
    out: Dict[str, torch.Tensor] = {}
    for shard in sorted(set(weight_map.values())):
        out.update(read(directory / shard))
    missing = sorted(set(weight_map) - set(out))
    if missing:
        raise KeyError(f"{directory / index} names tensors its shards lack: {missing}")
    return out


def _read_bin(path) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_state_dict(directory) -> Dict[str, torch.Tensor]:
    """The model's state dict (HF key names, HF (out, in) Linear layout) on
    the CPU, from the first weight layout the directory holds."""
    directory = Path(directory)
    first = next((f for f in _WEIGHT_FILES if (directory / f).is_file()), None)
    if first is None:
        raise FileNotFoundError(f"{directory}: none of {', '.join(_WEIGHT_FILES)}")
    if first == "model.safetensors":
        return read_safetensors(directory / first)
    if first == "model.safetensors.index.json":
        return _read_shards(directory, first, read_safetensors)
    if first == "pytorch_model.bin":
        return _read_bin(directory / first)
    return _read_shards(directory, first, _read_bin)
