"""Carry weights from the JAX package's variable trees into the port.

The JAX models keep ``{"params": ..., "batch_stats": ...}`` trees of arrays
in their own layouts; the port's modules use the reference's torch
state-dict keys and layouts. These functions map one onto the other (the
port's own copy of the mapping, taking nested dicts of anything
``np.asarray`` accepts) and return state dicts of CPU tensors that load
into :class:`~ocrs_models_torch.models.RecognitionModel`,
:class:`~ocrs_models_torch.models.DetectionModel` and
:class:`~ocrs_models_torch.models.LayoutModel` with ``strict=True``.
State dicts in the reference's ``.pt`` format load unchanged. The
``jax_variables_from_*_state_dict`` functions map back the other way, for
the ``.npz`` export.

Layouts: flax HWIO conv ``[kh, kw, I/g, O]`` -> torch ``[O, I/g, kh, kw]``;
flax transpose conv (``transpose_kernel=True``) ``[kh, kw, O, I]`` -> torch
``[I, O, kh, kw]``; dense ``[I, O]`` -> ``[O, I]``; GRU ``[F, 3H]`` ->
``[3H, F]``; batch norm scale/bias/mean/var -> weight/bias/running_*;
layer norm scale/bias -> weight/bias.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

_REC_CONVS = {
    "conv0": ("conv.0", True),
    "conv3": ("conv.3", False),
    "conv7": ("conv.7", True),
    "conv9": ("conv.9", False),
    "conv13": ("conv.13", True),
    "conv15": ("conv.15", False),
    "conv19": ("conv.19", False),
}
_REC_BNS = {"bn4": "conv.4", "bn10": "conv.10", "bn16": "conv.16", "bn20": "conv.20"}


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32, order="C"))


def _conv(p: Mapping[str, Any], key: str, out: dict, bias: bool = True) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if bias:
        out[f"{key}.bias"] = _t(p["bias"])


def _dense(p: Mapping[str, Any], key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def _bn(p: Mapping[str, Any], s: Mapping[str, Any], key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _double_conv(p, s, key: str, out: dict) -> None:
    for i, name in enumerate(("conv0", "conv1")):
        blk, k = p[name], f"{key}.seq.{i}"
        out[f"{k}.seq.0.weight"] = _t(np.asarray(blk["dw_kernel"]).transpose(3, 2, 0, 1))
        out[f"{k}.seq.1.weight"] = _t(np.asarray(blk["pw_kernel"]).T[:, :, None, None])
        _bn(blk["bn"], s[name]["bn"], f"{k}.seq.2", out)


def detection_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``DetectionModel`` variables -> the port's detection state dict."""
    p, s = variables["params"], variables["batch_stats"]
    n_levels = sum(1 for k in p if k.startswith("down_"))
    out: dict = {}
    _double_conv(p["in_conv"], s["in_conv"], "in_conv", out)
    for i in range(n_levels):
        _double_conv(p[f"down_{i}"], s[f"down_{i}"], f"down.{i}.seq.0", out)
        _conv(p[f"up_{i}"]["up"], f"up.{i}.up", out)
        _double_conv(p[f"up_{i}"]["contract"], s[f"up_{i}"]["contract"], f"up.{i}.contract", out)
    _conv(p["out_conv"], "out_conv.0", out)
    return out


def bigru_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``BiGRU`` params (``layer_{k}/{w,b}_{ih,hh}_{fwd,bwd}``) -> the
    state dict of :class:`~ocrs_models_torch.ops.BiGRU` (and ``nn.GRU``)."""
    out: dict = {}
    for layer in range(len(params)):
        lp = params[f"layer_{layer}"]
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            out[f"weight_ih_l{layer}{sfx}"] = _t(np.asarray(lp[f"w_ih_{direction}"]).T)
            out[f"weight_hh_l{layer}{sfx}"] = _t(np.asarray(lp[f"w_hh_{direction}"]).T)
            out[f"bias_ih_l{layer}{sfx}"] = _t(lp[f"b_ih_{direction}"])
            out[f"bias_hh_l{layer}{sfx}"] = _t(lp[f"b_hh_{direction}"])
    return out


def recognition_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``RecognitionModel`` variables -> the port's recognition state dict."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    for name, (key, bias) in _REC_CONVS.items():
        _conv(p[name], key, out, bias=bias)
    for name, key in _REC_BNS.items():
        _bn(p[name], s[name], key, out)
    for key, value in bigru_state_dict_from_jax(p["gru"]).items():
        out[f"gru.{key}"] = value
    _dense(p["output"], "output.0", out)
    return out


def _layer_norm(p: Mapping[str, Any], key: str, out: dict) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])


def layout_state_dict_from_jax(
    variables: Mapping[str, Any], n_layers: int = 6, pos_embedding: str = "sin"
) -> dict[str, torch.Tensor]:
    """JAX ``LayoutModel`` variables -> the port's layout state dict (the
    reference's keys): ``qkv_kernel [d, 3d]`` -> ``in_proj_weight [3d, d]``,
    dense ``[I, O]`` -> ``[O, I]``, LayerNorm scale/bias -> weight/bias."""
    p = variables["params"]
    out: dict = {}
    if pos_embedding == "mlp":
        _dense(p["embed0"], "embed.0", out)
        _dense(p["embed1"], "embed.2", out)
    for i in range(n_layers):
        lp, key = p[f"layer_{i}"], f"encode.layers.{i}"
        out[f"{key}.self_attn.in_proj_weight"] = _t(np.asarray(lp["qkv_kernel"]).T)
        out[f"{key}.self_attn.in_proj_bias"] = _t(lp["qkv_bias"])
        _dense(lp["out_proj"], f"{key}.self_attn.out_proj", out)
        _dense(lp["linear1"], f"{key}.linear1", out)
        _dense(lp["linear2"], f"{key}.linear2", out)
        _layer_norm(lp["norm1"], f"{key}.norm1", out)
        _layer_norm(lp["norm2"], f"{key}.norm2", out)
    _dense(p["classify"], "classify", out)
    return out


# ------------------------------------------------------------- the inverse
# The port's state dicts -> the JAX package's variable trees (the port's
# copy of ``ocrs_models_tpu/export/torch_import.py``), for the ``.npz``
# export: ``{"params": ..., "batch_stats": ...}`` with the flax module and
# leaf names, C-contiguous float32 numpy leaves. ``num_batches_tracked``
# has no flax counterpart and is dropped.


def _np(v, perm: tuple[int, ...] | None = None) -> np.ndarray:
    """``v`` as a C-contiguous float32 array, axes permuted by ``perm``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v, dtype=np.float32)
    return np.ascontiguousarray(v if perm is None else v.transpose(perm))


def _conv_to_jax(sd: Mapping[str, Any], key: str, bias: bool = True) -> dict:
    # conv [O, I/g, kh, kw] -> HWIO; transpose conv [I, O, kh, kw] ->
    # [kh, kw, O, I] (flax transpose_kernel=True): the same permutation.
    out = {"kernel": _np(sd[f"{key}.weight"], (2, 3, 1, 0))}
    if bias:
        out["bias"] = _np(sd[f"{key}.bias"])
    return out


def _dense_to_jax(sd: Mapping[str, Any], key: str) -> dict:
    return {"kernel": _np(sd[f"{key}.weight"], (1, 0)), "bias": _np(sd[f"{key}.bias"])}


def _bn_to_jax(sd: Mapping[str, Any], key: str) -> tuple[dict, dict]:
    params = {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}
    return params, {"mean": _np(sd[f"{key}.running_mean"]), "var": _np(sd[f"{key}.running_var"])}


def _double_conv_to_jax(sd: Mapping[str, Any], key: str) -> tuple[dict, dict]:
    params, stats = {}, {}
    for i, name in enumerate(("conv0", "conv1")):
        k = f"{key}.seq.{i}"
        bn_p, bn_s = _bn_to_jax(sd, f"{k}.seq.2")
        params[name] = {
            "dw_kernel": _np(sd[f"{k}.seq.0.weight"], (2, 3, 1, 0)),
            "pw_kernel": _np(_np(sd[f"{k}.seq.1.weight"])[:, :, 0, 0], (1, 0)),
            "bn": bn_p,
        }
        stats[name] = {"bn": bn_s}
    return params, stats


def jax_variables_from_detection_state_dict(sd: Mapping[str, Any], n_levels: int = 6) -> dict:
    """The port's detection state dict -> JAX ``DetectionModel`` variables."""
    params: dict = {}
    stats: dict = {}
    params["in_conv"], stats["in_conv"] = _double_conv_to_jax(sd, "in_conv")
    for i in range(n_levels):
        params[f"down_{i}"], stats[f"down_{i}"] = _double_conv_to_jax(sd, f"down.{i}.seq.0")
        up_p, up_s = _double_conv_to_jax(sd, f"up.{i}.contract")
        params[f"up_{i}"] = {"up": _conv_to_jax(sd, f"up.{i}.up"), "contract": up_p}
        stats[f"up_{i}"] = {"contract": up_s}
    params["out_conv"] = _conv_to_jax(sd, "out_conv.0")
    return {"params": params, "batch_stats": stats}


def jax_variables_from_recognition_state_dict(sd: Mapping[str, Any], gru_layers: int = 2) -> dict:
    """The port's recognition state dict -> JAX ``RecognitionModel`` variables."""
    params: dict = {}
    stats: dict = {}
    for name, (key, bias) in _REC_CONVS.items():
        params[name] = _conv_to_jax(sd, key, bias=bias)
    for name, key in _REC_BNS.items():
        params[name], stats[name] = _bn_to_jax(sd, key)
    gru: dict = {}
    for layer in range(gru_layers):
        lp = {}
        for direction, sfx in (("fwd", ""), ("bwd", "_reverse")):
            lp[f"w_ih_{direction}"] = _np(sd[f"gru.weight_ih_l{layer}{sfx}"], (1, 0))
            lp[f"w_hh_{direction}"] = _np(sd[f"gru.weight_hh_l{layer}{sfx}"], (1, 0))
            lp[f"b_ih_{direction}"] = _np(sd[f"gru.bias_ih_l{layer}{sfx}"])
            lp[f"b_hh_{direction}"] = _np(sd[f"gru.bias_hh_l{layer}{sfx}"])
        gru[f"layer_{layer}"] = lp
    params["gru"] = gru
    params["output"] = _dense_to_jax(sd, "output.0")
    return {"params": params, "batch_stats": stats}


def jax_variables_from_layout_state_dict(
    sd: Mapping[str, Any], n_layers: int = 6, pos_embedding: str = "sin"
) -> dict:
    """The port's layout state dict -> JAX ``LayoutModel`` variables (no
    ``batch_stats``: the layout model has none)."""
    params: dict = {}
    if pos_embedding == "mlp":
        params["embed0"] = _dense_to_jax(sd, "embed.0")
        params["embed1"] = _dense_to_jax(sd, "embed.2")
    for i in range(n_layers):
        key = f"encode.layers.{i}"
        params[f"layer_{i}"] = {
            "qkv_kernel": _np(sd[f"{key}.self_attn.in_proj_weight"], (1, 0)),
            "qkv_bias": _np(sd[f"{key}.self_attn.in_proj_bias"]),
            "out_proj": _dense_to_jax(sd, f"{key}.self_attn.out_proj"),
            "linear1": _dense_to_jax(sd, f"{key}.linear1"),
            "linear2": _dense_to_jax(sd, f"{key}.linear2"),
            "norm1": {"scale": _np(sd[f"{key}.norm1.weight"]), "bias": _np(sd[f"{key}.norm1.bias"])},
            "norm2": {"scale": _np(sd[f"{key}.norm2.weight"]), "bias": _np(sd[f"{key}.norm2.bias"])},
        }
    params["classify"] = _dense_to_jax(sd, "classify")
    return {"params": params}
