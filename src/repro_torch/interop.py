"""Bridge from the reference's numpy images to the port's tensors.

``params_from_numpy`` takes the JAX parameter tree as nested dicts of numpy
arrays (layers stacked on a leading axis, a quantized weight as
``{"values", "scale"}``, bf16 leaves as float32 arrays, which is exact) and
returns the port's parameters: the same tree with each stacked layer list
(``blocks``; the hybrid's ``super`` and ``tail``; the enc-dec family's
``enc_blocks`` and ``dec_blocks``) split into a list of
per-layer dicts, float leaves in the config's compute dtype, and
quantization scales and the leaves the reference keeps in float32 whatever
the compute dtype (an MoE router, the SSD's dt_bias, A_log and D_skip, the
RG-LRU's lam) in float32. ``kv_cache_from_numpy``,
``recurrent_state_from_numpy`` and ``encdec_caches_from_numpy`` do the
same for a cache, a recurrent state and the enc-dec family's caches;
``adamw_state_from_numpy`` for the reference's optimizer state,
``stage_params_from_numpy`` for one pod rank's stage of the reference's
pipeline-staged parameters (``repro.core.pipeline.stage_params``), and
``tree_to_numpy`` turns the port's parameters, gradients or optimizer
state back into the reference's layout (layers stacked), so the two can
be compared leaf by leaf. Turning a JAX pytree into numpy is the caller's
job (the tests' own helper); this module imports no JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kv.cache import KVCache
from repro_torch.kv.state import RecurrentState
from repro_torch.models.common import dtype_of
from repro_torch.optim.adamw import AdamWState
from repro_torch.quant.int8 import QuantizedTensor


def _leaf(a: np.ndarray, dtype, device) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# subtrees and leaves the reference makes in float32 at any compute dtype:
# the MoE router (``repro.models.moe.make_moe_params``), the SSD's decay
# and skip parameters (``repro.models.ssm.make_ssd_params``) and the
# RG-LRU's lam (``repro.models.rglru.make_rglru_params``)
F32_SUBTREES = ("router", "dt_bias", "A_log", "D_skip", "lam")
# stacked per-layer subtrees (layers on the leading axis)
LAYER_STACKS = ("blocks", "super", "tail", "enc_blocks", "dec_blocks")


def _convert(node, dtype, device):
    if isinstance(node, dict):
        if set(node) == {"values", "scale"}:
            return QuantizedTensor(_leaf(node["values"], None, device),
                                   _leaf(node["scale"], torch.float32,
                                         device))
        return {k: _convert(v, torch.float32 if k in F32_SUBTREES
                            else dtype, device) for k, v in node.items()}
    return _leaf(np.asarray(node), dtype, device)


def _layer(node, i: int):
    if isinstance(node, QuantizedTensor):
        return node[i]
    if isinstance(node, dict):
        return {k: _layer(v, i) for k, v in node.items()}
    return node[i]


def params_from_numpy(tree: Dict[str, Any], cfg,
                      device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    return _split_layers(_convert(tree, dtype_of(cfg), dev))


def stage_params_from_numpy(tree: Dict[str, Any], cfg, stage: int,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """``tree``: the reference's staged parameters as numpy (its
    ``stage_params``: every block leaf (n_stages, L / n_stages, ...), the
    head leaves unstaged) -> the port's parameters of pipeline stage
    ``stage`` (``core/pipeline.py::stage_params(..., stage=)``): ``blocks``
    the list of that stage's layers, the head leaves whole."""
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return np.asarray(node)[stage]
    out = dict(tree)
    out["blocks"] = pick(tree["blocks"])
    return params_from_numpy(out, cfg, device)


def _split_layers(out: Dict[str, Any]) -> Dict[str, Any]:
    for name in LAYER_STACKS:
        if name in out:
            stacked = out[name]
            n = _depth(stacked)
            out[name] = [_layer(stacked, i) for i in range(n)]
    return out


def adamw_state_from_numpy(tree: Dict[str, Any],
                           device: DeviceLike = None) -> AdamWState:
    """The reference's ``AdamWState`` as numpy, {"step", "mu", "nu"} (the
    moments stacked over layers, float32), -> the port's: the step a 0-d
    int32 tensor, the moments float32 with the layer lists split."""
    dev = resolve_device(device)
    return AdamWState(
        step=_leaf(np.asarray(tree["step"], np.int32), None, dev),
        mu=_split_layers(_convert(tree["mu"], torch.float32, dev)),
        nu=_split_layers(_convert(tree["nu"], torch.float32, dev)))


def tree_to_numpy(tree) -> Any:
    """The port's parameters or optimizer state back to numpy in the
    reference's layout: each per-layer list stacked on a leading axis,
    bf16 leaves as float32 (exact), a quantized weight as {"values",
    "scale"}, an ``AdamWState`` as {"step", "mu", "nu"}. Gradients (a
    parameter-shaped tree) convert the same way."""
    if isinstance(tree, AdamWState):
        return {"step": tree_to_numpy(tree.step),
                "mu": tree_to_numpy(tree.mu), "nu": tree_to_numpy(tree.nu)}
    if isinstance(tree, QuantizedTensor):
        return {"values": tree_to_numpy(tree.values),
                "scale": tree_to_numpy(tree.scale)}
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return _stack([tree_to_numpy(v) for v in tree])
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers])
                for k in layers[0]}
    return np.stack(layers)


def _depth(node) -> int:
    """Leading (layer) extent of a stacked subtree."""
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return (node.values if isinstance(node, QuantizedTensor)
            else node).shape[0]


def kv_cache_from_numpy(tree: Dict[str, Any], cfg,
                        device: DeviceLike = None,
                        window: int = 0) -> KVCache:
    """``tree``: {"k", "v", "k_scale", "v_scale", "length"} numpy arrays
    (scales None for a float cache), plus "hot_k" and "hot_v" for a tiered
    cache, whose geometry (hot_window, cold block and dtype) is the
    config's. Quantized tiers keep their int8 bytes (packed int4 nibbles
    included); float leaves take the config's compute dtype. ``window``
    > 0: a ring cache (the hybrid's local attention)."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)

    def t(name, dtype):
        a = tree.get(name)
        return None if a is None else _leaf(np.asarray(a), dtype, dev)

    tiers = {}
    if tree.get("hot_k") is not None:
        tiers = dict(hot_k=t("hot_k", dt), hot_v=t("hot_v", dt),
                     hot_window=cfg.hot_window, cold_block=cfg.kv_cold_block,
                     cold_dtype=cfg.kv_cold_dtype)
    return KVCache(t("k", dt), t("v", dt), t("k_scale", torch.float32),
                   t("v_scale", torch.float32),
                   _leaf(np.asarray(tree["length"], np.int32), None, dev),
                   window=window, **tiers)


def recurrent_state_from_numpy(tree: Dict[str, Any],
                               device: DeviceLike = None) -> RecurrentState:
    """``tree``: {"h", "conv"} numpy arrays of the reference's
    ``RecurrentState``; both stay float32."""
    dev = resolve_device(device)
    return RecurrentState(
        h=_leaf(np.asarray(tree["h"], np.float32), torch.float32, dev),
        conv=_leaf(np.asarray(tree["conv"], np.float32), torch.float32, dev))


def encdec_caches_from_numpy(tree: Dict[str, Any], cfg,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """``tree``: {"self": the ``kv_cache_from_numpy`` tree of the self
    cache, "cross": {"k", "v"} numpy arrays (L,B,n_kv,F,hd)} -> the
    enc-dec family's caches; the cross K/V take the compute dtype."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    return {"self": kv_cache_from_numpy(tree["self"], cfg, dev),
            "cross": {n: _leaf(np.asarray(tree["cross"][n]), dt, dev)
                      for n in ("k", "v")}}


def to_device(tree, device):
    """The same parameter tree with every tensor moved to ``device``."""
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(tree.values.to(device), tree.scale.to(device))
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)
