"""Convert the JAX package's SpatialNet, OnlineSpatialNet, NBC, NBC2 and
NB-BLSTM parameter trees into the port's ``state_dict``.

For NBC the exact inverse of ``nbss_tpu.utils.torch_compat.nbc_params_from_torch``
(``nbc_state_dict_from_flax``); for NBC2 of ``nbc2_params_from_torch``
(``nbc2_state_dict_from_flax``); for NB-BLSTM of
``blstm2_fc1_params_from_torch`` (``blstm2_fc1_state_dict_from_flax``).

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


RETENTION_PROJS = ("q_proj", "k_proj", "v_proj", "g_proj", "out_proj")


def retention_state_dict_from_flax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX MultiScaleRetention params ->
    ``nbss_tpu_torch.models.retention.MultiScaleRetention`` state_dict under
    ``prefix``: each bias-free projection's flax kernel [in, out] becomes a
    weight [out, in] (no ``k_proj`` under share_qk). Raises on a key that is
    neither a projection nor its kernel."""
    p = params.get("params", params)
    extra = set(p) - set(RETENTION_PROJS)
    if extra or "q_proj" not in p:
        raise KeyError(f"retention params: unexpected {sorted(extra)} or no q_proj in {sorted(p)}")
    sd = {}
    for name, proj in p.items():
        if set(proj) != {"kernel"}:
            raise KeyError(f"retention {name}: expected only a kernel, got {sorted(proj)}")
        sd[f"{prefix}{name}.weight"] = _dense(proj["kernel"])
    return sd


def online_spatialnet_state_dict_from_flax(params: Mapping, num_layers: int,
                                           full_share: int = 0) -> Dict[str, torch.Tensor]:
    """JAX OnlineSpatialNet params ->
    ``nbss_tpu_torch.models.online_spatialnet.OnlineSpatialNet`` state_dict,
    for each branch: the time module ``mhsa`` is a MultiheadAttention
    (``mhsa(N)``), a MultiScaleRetention (``ret(...)``) or a Mamba block
    (``mamba(...)``); the FFN
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
        elif "q_proj" in lp["mhsa"]:
            sd.update(retention_state_dict_from_flax(lp["mhsa"], f"{t}.mhsa."))
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


def _nbc2_norm(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """An NBC2 norm: the JAX ``_NBC2Norm`` holds one child, ``LayerNorm_0``,
    ``GroupBatchNorm_0`` or ``GroupNorm_0`` by its kind, each with a scale
    and a bias over the channels."""
    (child,) = p.values()
    return _norm(child, prefix)


def nbc2_state_dict_from_flax(params: Mapping, n_layers: int) -> Dict[str, torch.Tensor]:
    """JAX NBC2 params -> ``nbss_tpu_torch.models.nbc2.NBC2`` state_dict (the
    reference torch NBC2's names), the exact inverse of
    ``nbss_tpu.utils.torch_compat.nbc2_params_from_torch``: the encoder conv,
    the decoder Dense, and per block the norms, the packed attention
    projections, linear1/linear2 and the grouped convs at ``conv.{1,3,6}``
    with the mid norm at ``conv.4``. Each norm maps by its kind, so an NBC2
    with other norms converts too (``nbc2_params_from_torch`` assumes LN,
    GBN, GBN). The GroupBatchNorm scale and bias stay [H]:
    ``nbc2_params_from_torch`` reshapes the reference's to [H] with
    ``reshape(-1)``, and the shape they had there is not recorded."""
    p = params.get("params", params)
    sd = {"encoder.weight": _conv(p["encoder"]["Conv_0"]["kernel"]),
          "encoder.bias": _t(p["encoder"]["Conv_0"]["bias"]),
          "decoder.weight": _dense(p["decoder"]["kernel"]),
          "decoder.bias": _t(p["decoder"]["bias"])}
    for l in range(n_layers):
        t, bp = f"sa_layers.{l}", p[f"block_{l}"]
        sd.update(_nbc2_norm(bp["norm1"], f"{t}.norm1"))
        sd.update(_mhsa(bp["self_attn"], f"{t}.self_attn"))
        sd.update(_nbc2_norm(bp["norm2"], f"{t}.norm2"))
        sd.update(_linear(bp["linear1"], f"{t}.linear1"))
        for name, idx in (("conv1", 1), ("conv2", 3), ("conv3", 6)):
            sd.update(_conv_layer(bp[name], f"{t}.conv.{idx}"))
        sd.update(_nbc2_norm(bp["conv_norm"], f"{t}.conv.4"))
        sd.update(_linear(bp["linear2"], f"{t}.linear2"))
    return sd


def _lstm_layer(cell_fwd: Mapping, cell_bwd: Mapping, prefix: str,
                layer: int) -> Dict[str, torch.Tensor]:
    """One bidirectional layer of ``nn.LSTM`` from two flax
    ``OptimizedLSTMCell``s: the gate kernels ``i{i,f,g,o}`` / ``h{i,f,g,o}``
    [in, h] stack into weight_ih [4h, in] / weight_hh [4h, h] in torch's gate
    order i, f, g, o; the flax bias (on the ``h*`` Denses) becomes bias_ih,
    and bias_hh is zero."""
    sd = {}
    for cell, sfx in ((cell_fwd, f"l{layer}"), (cell_bwd, f"l{layer}_reverse")):
        sd[f"{prefix}.weight_ih_{sfx}"] = torch.cat([_dense(cell[f"i{g}"]["kernel"])
                                                    for g in "ifgo"])
        sd[f"{prefix}.weight_hh_{sfx}"] = torch.cat([_dense(cell[f"h{g}"]["kernel"])
                                                    for g in "ifgo"])
        sd[f"{prefix}.bias_ih_{sfx}"] = torch.cat([_t(cell[f"h{g}"]["bias"]) for g in "ifgo"])
        sd[f"{prefix}.bias_hh_{sfx}"] = torch.zeros_like(sd[f"{prefix}.bias_ih_{sfx}"])
    return sd


def blstm2_fc1_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BLSTM2_FC1 params -> ``nbss_tpu_torch.models.nb_blstm.BLSTM2_FC1``
    state_dict (the reference torch names), the inverse of
    ``nbss_tpu.utils.torch_compat.blstm2_fc1_params_from_torch``; the number
    of repeated second layers is read from the tree. This direction is exact:
    the flax bias goes to bias_ih and bias_hh is zero, so
    ``blstm2_fc1_params_from_torch`` gives the tree back bit for bit. The
    other direction sums the reference's two biases into one, which this
    function cannot split again."""
    p = params.get("params", params)
    sd = _lstm_layer(p["blstm1"]["fwd_0"], p["blstm1"]["bwd_0"], "blstm1", 0)
    n_repeat = sum(1 for k in p["blstm2"] if k.startswith("fwd_"))
    for l in range(n_repeat):
        sd.update(_lstm_layer(p["blstm2"][f"fwd_{l}"], p["blstm2"][f"bwd_{l}"], "blstm2", l))
    sd["linear.weight"] = _dense(p["linear"]["kernel"])
    sd["linear.bias"] = _t(p["linear"]["bias"])
    return sd
