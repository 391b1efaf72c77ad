"""Convert the JAX package's SpatialNet, OnlineSpatialNet and NBC parameter
trees into the port's ``state_dict``.

For NBC the exact inverse of ``nbss_tpu.utils.torch_compat.nbc_params_from_torch``
(``nbc_state_dict_from_flax``).

For the mhsa and T-ConvFFN layers of OnlineSpatialNet, whose layout is
SpatialNet's module for module, the exact inverse of
``nbss_tpu.utils.torch_compat.online_spatialnet_params_from_torch``.

For SpatialNet the exact inverse of
``nbss_tpu.utils.torch_compat.spatialnet_params_from_torch``:
flax Dense kernels [in, out] become Linear weights [out, in], flax Conv
kernels [k, in/groups, out] become Conv1d weights [out, in/groups, k], 1x1
convs get their trailing kernel axis back, and LayerNorm ``scale`` becomes
``weight``. The input is the nested dict of arrays that the JAX package's
checkpoints hold (with or without the top-level ``"params"`` key); the output
maps names to float32 tensors.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(kernel) -> torch.Tensor:  # [k, in/g, out] -> [out, in/g, k]
    return _t(np.transpose(np.asarray(kernel), (2, 1, 0)))


def _dense(kernel) -> torch.Tensor:  # [in, out] -> [out, in]
    return _t(np.transpose(np.asarray(kernel)))


def _dense_to_1x1(kernel) -> torch.Tensor:  # [in, out] -> [out, in, 1]
    return _dense(kernel)[:, :, None]


def _cross_band(sd: Dict[str, torch.Tensor], t: str, lp: Mapping, full: Mapping) -> None:
    """The cross-band block of one layer, the same in SpatialNet and
    OnlineSpatialNet: fconv1, the shared full-band LinearGroup, squeeze,
    unsqueeze, fconv2."""
    sd[f"{t}.full.weight"], sd[f"{t}.full.bias"] = _t(full["weight"]), _t(full["bias"])
    for fc in ("fconv1", "fconv2"):
        sd.update(_norm(lp[f"{fc}_norm"], f"{t}.{fc}.0"))
        sd.update(_conv_layer(lp[f"{fc}_conv"], f"{t}.{fc}.1"))
        sd[f"{t}.{fc}.2.weight"] = _t(lp[f"{fc}_act"]["alpha"])
    sd.update(_norm(lp["norm_full"], f"{t}.norm_full"))
    sd.update(_pointwise(lp["squeeze"], f"{t}.squeeze.0"))
    sd.update(_pointwise(lp["unsqueeze"], f"{t}.unsqueeze.0"))


def _norm(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(p["bias"])}


def _conv_layer(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _conv(p["Conv_0"]["kernel"]),
            f"{prefix}.bias": _t(p["Conv_0"]["bias"])}


def _pointwise(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _dense_to_1x1(p["Dense_0"]["kernel"]),
            f"{prefix}.bias": _t(p["Dense_0"]["bias"])}


def _ends(p: Mapping) -> Dict[str, torch.Tensor]:
    return {"encoder.weight": _conv(p["encoder"]["Conv_0"]["kernel"]),
            "encoder.bias": _t(p["encoder"]["Conv_0"]["bias"]),
            "decoder.weight": _dense(p["decoder"]["Dense_0"]["kernel"]),
            "decoder.bias": _t(p["decoder"]["Dense_0"]["bias"])}


def _mhsa(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """MultiheadAttention: the packed in_proj and the out_proj Dense."""
    return {f"{prefix}.in_proj_weight": _dense(p["in_proj"]["Dense_0"]["kernel"]),
            f"{prefix}.in_proj_bias": _t(p["in_proj"]["Dense_0"]["bias"]),
            f"{prefix}.out_proj.weight": _dense(p["out_proj"]["Dense_0"]["kernel"]),
            f"{prefix}.out_proj.bias": _t(p["out_proj"]["Dense_0"]["bias"])}


def _tconvffn(lp: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """The T-ConvFFN as torch NBSS indexes its nn.Sequential: 0 norm, 1 up,
    3/5/8 the grouped convs, 6 the mid norm, 10 down."""
    sd = _norm(lp["tconvffn_norm"], f"{prefix}.0")
    sd.update(_pointwise(lp["tconvffn_up"], f"{prefix}.1"))
    for name, idx in (("tconvffn_conv1", 3), ("tconvffn_conv2", 5), ("tconvffn_conv3", 8)):
        sd.update(_conv_layer(lp[name], f"{prefix}.{idx}"))
    sd.update(_norm(lp["tconvffn_midnorm"], f"{prefix}.6"))
    sd.update(_pointwise(lp["tconvffn_down"], f"{prefix}.10"))
    return sd


def spatialnet_state_dict_from_flax(params: Mapping, num_layers: int,
                                    full_share: int = 0) -> Dict[str, torch.Tensor]:
    """JAX SpatialNet params -> ``nbss_tpu_torch.models.SpatialNet`` state_dict:
    the layout of OnlineSpatialNet's mhsa and T-ConvFFN layers."""
    return online_spatialnet_state_dict_from_flax(params, num_layers, full_share)


def mamba_state_dict_from_flax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX MambaBlock params -> ``nbss_tpu_torch.models.mamba.MambaBlock``
    state_dict under ``prefix`` (mamba-ssm names): flax Dense kernels
    [in, out] become weights [out, in], the depthwise conv kernel [k, 1, D]
    becomes [D, 1, k]."""
    p = params.get("params", params)
    return {f"{prefix}in_proj.weight": _dense(p["in_proj"]["kernel"]),
            f"{prefix}conv1d.weight": _conv(p["conv1d_weight"]),
            f"{prefix}conv1d.bias": _t(p["conv1d_bias"]),
            f"{prefix}x_proj.weight": _dense(p["x_proj"]["kernel"]),
            f"{prefix}dt_proj.weight": _dense(p["dt_proj"]["kernel"]),
            f"{prefix}dt_proj.bias": _t(p["dt_proj"]["bias"]),
            f"{prefix}A_log": _t(p["A_log"]),
            f"{prefix}D": _t(p["D"]),
            f"{prefix}out_proj.weight": _dense(p["out_proj"]["kernel"])}


def online_spatialnet_state_dict_from_flax(params: Mapping, num_layers: int,
                                           full_share: int = 0) -> Dict[str, torch.Tensor]:
    """JAX OnlineSpatialNet params ->
    ``nbss_tpu_torch.models.online_spatialnet.OnlineSpatialNet`` state_dict,
    for each branch the port has: the time module ``mhsa`` is a
    MultiheadAttention (``mhsa(N)``) or a Mamba block (``mamba(...)``); the FFN
    the causal T-ConvFFN, named as SpatialNet's, or the second Mamba block
    (the JAX ``tconvffn_mamba``, the port's ``tconvffn``)."""
    p = params.get("params", params)
    sd = _ends(p)
    n_fulls = min(full_share, num_layers - 1) + 1
    for l in range(num_layers):
        t, lp = f"layers.{l}", p[f"layer_{l}"]
        _cross_band(sd, t, lp, p[f"full_{min(l, n_fulls - 1)}"])
        sd.update(_norm(lp["norm_mhsa"], f"{t}.norm_mhsa"))
        if "A_log" in lp["mhsa"]:
            sd.update(mamba_state_dict_from_flax(lp["mhsa"], f"{t}.mhsa."))
        else:
            sd.update(_mhsa(lp["mhsa"], f"{t}.mhsa"))
        if "tconvffn_mamba" in lp:
            sd.update(_norm(lp["norm_tconvffn"], f"{t}.norm_tconvffn"))
            sd.update(mamba_state_dict_from_flax(lp["tconvffn_mamba"], f"{t}.tconvffn."))
        else:
            sd.update(_tconvffn(lp, f"{t}.tconvffn"))
    return sd


def _convT(kernel) -> torch.Tensor:  # flax [k, in, out] -> torch ConvTranspose1d [in, out, k]
    return _t(np.transpose(np.asarray(kernel)[::-1], (1, 2, 0)))


def _linear(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """A Dense (under ``Dense_0``) as a Linear; no bias if it has none."""
    sd = {f"{prefix}.weight": _dense(p["Dense_0"]["kernel"])}
    if "bias" in p["Dense_0"]:
        sd[f"{prefix}.bias"] = _t(p["Dense_0"]["bias"])
    return sd


def nbc_state_dict_from_flax(params: Mapping, n_layers: int,
                             n_conv_layers: int = 3) -> Dict[str, torch.Tensor]:
    """JAX NBC params -> ``nbss_tpu_torch.models.nbc.NBC`` state_dict (the
    reference torch NBC's names), the exact inverse of
    ``nbss_tpu.utils.torch_compat.nbc_params_from_torch``: the ConvTranspose
    decoder's flax kernel [k, in, out] is flipped back along k into torch's
    [in, out, k]; the conv stack's GroupNorms sit at ``conv.{3i+1}``."""
    p = params.get("params", params)
    sd = {"encoder.weight": _conv(p["encoder"]["Conv_0"]["kernel"]),
          "encoder.bias": _t(p["encoder"]["Conv_0"]["bias"]),
          "decoder.weight": _convT(p["decoder"]["ConvTranspose_0"]["kernel"]),
          "decoder.bias": _t(p["decoder"]["ConvTranspose_0"]["bias"])}
    for l in range(n_layers):
        t, bp = f"sa_layers.{l}", p[f"block_{l}"]
        sd.update(_norm(bp["norm1"], f"{t}.norm1"))
        sd.update(_norm(bp["norm2"], f"{t}.norm2"))
        sa = bp["self_attn"]
        for proj in ("query_proj", "key_proj", "value_proj", "out_proj", "pos_proj"):
            sd.update(_linear(sa[proj], f"{t}.self_attn.{proj}"))
        sd[f"{t}.self_attn.u_bias"] = _t(sa["u_bias"])
        sd[f"{t}.self_attn.v_bias"] = _t(sa["v_bias"])
        sd.update(_linear(bp["linear1"], f"{t}.linear1"))
        sd.update(_linear(bp["linear2"], f"{t}.linear2"))
        for i in range(n_conv_layers):
            sd.update(_conv_layer(bp[f"conv_{i}"], f"{t}.conv.{3 * i}"))
            sd.update(_norm(bp[f"conv_norm_{i}"], f"{t}.conv.{3 * i + 1}"))
    return sd
