"""Weight bridge into the port's reference-layout state dict.

Counterpart of `usot_tpu/models/convert.py:23-254`. The port's modules
carry the reference's key names, so a published `USOT*.pth` loads after
`strip_prefix` (`model.load_state_dict(strip_prefix(ckpt["state_dict"]))`
for a checkpoint that nests its state dict), and JAX-side flax variables
load through
`state_dict_from_flax` (the port's own copy of the inverse mapping of
`invert_usot_checkpoint`):

  flax HWIO conv kernel   -> torch OIHW weight (transpose 3, 2, 0, 1)
  bn scale / bias         -> BatchNorm weight / bias
  bn mean / var (stats)   -> BatchNorm running_mean / running_var
  head bias (1, 1, 1, 4)  -> (1, 4, 1, 1)

`num_batches_tracked` is not written: the port's BatchNorm keeps the
buffer registered, and a missing entry loads with strict=True.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LAYER_BLOCKS = {"layer1": 3, "layer2": 4, "layer3": 6}
_SCALES = (("matrix11", "m11"), ("matrix12", "m12"), ("matrix21", "m21"))


def strip_prefix(state: Dict) -> Dict:
    """Drop the `module.` / `model.` / `feature_extractor.` prefixes that
    published checkpoints carry."""
    out = {}
    for k, v in state.items():
        for pre in ("module.", "model.", "feature_extractor."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _oihw(w) -> torch.Tensor:
    return _t(np.transpose(w, (3, 2, 0, 1)))


def _bn(sd, params, stats, key, path):
    sd[key + ".weight"] = _t(_get(params, path + ["bn", "scale"]))
    sd[key + ".bias"] = _t(_get(params, path + ["bn", "bias"]))
    sd[key + ".running_mean"] = _t(_get(stats, path + ["bn", "mean"]))
    sd[key + ".running_var"] = _t(_get(stats, path + ["bn", "var"]))


def _convbn(sd, params, stats, conv_key, bn_key, path, bias_key=None):
    sd[conv_key] = _oihw(_get(params, path + ["conv", "kernel"]))
    if bias_key is not None:
        sd[bias_key] = _t(_get(params, path + ["conv", "bias"]))
    _bn(sd, params, stats, bn_key, path)


def state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax variables {'params', 'batch_stats'} (numpy trees, as
    `usot_tpu` writes them) -> state dict for the port's `USOTNet`."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    pre = "features.features."
    _convbn(sd, params, stats, pre + "conv1.weight", pre + "bn1",
            ["features", "stem"])
    for layer, blocks in _LAYER_BLOCKS.items():
        for i in range(blocks):
            tb = f"{pre}{layer}.{i}."
            fp = ["features", f"{layer}_{i}"]
            for j in (1, 2, 3):
                _convbn(sd, params, stats, tb + f"conv{j}.weight",
                        tb + f"bn{j}", fp + [f"cb{j}"])
            if "downsample" in params["features"][f"{layer}_{i}"]:
                _convbn(sd, params, stats, tb + "downsample.0.weight",
                        tb + "downsample.1", fp + ["downsample"])

    _convbn(sd, params, stats, "neck.downsample.0.weight",
            "neck.downsample.1", ["neck"])

    cm = "connect_model"
    for enc in ("cls_encode", "reg_encode"):
        for side in ("k", "s"):
            for t_name, f_name in _SCALES:
                tb = f"{cm}.{enc}.{t_name}_{side}."
                _convbn(sd, params, stats, tb + "0.weight", tb + "1",
                        ["connect", f"{enc}_{side}", f_name])

    for dw in ("cls_dw", "reg_dw"):
        sd[f"{cm}.{dw}.weight"] = _t(_get(params, ["connect", dw, "weight"]))

    for gen in ("conf_gen", "value_gen"):
        tb = f"{cm}.conf_fusion.{gen}."
        _convbn(sd, params, stats, tb + "0.weight", tb + "1",
                ["connect", "conf_fusion", gen], bias_key=tb + "0.bias")

    for tower in ("bbox_tower", "cls_tower", "cls_memory_tower"):
        for i in range(4):
            _convbn(sd, params, stats, f"{cm}.{tower}.{3 * i}.weight",
                    f"{cm}.{tower}.{3 * i + 1}",
                    ["connect", tower, f"block{i}"],
                    bias_key=f"{cm}.{tower}.{3 * i}.bias")

    for head in ("bbox_pred", "cls_pred", "cls_memory_pred"):
        sd[f"{cm}.{head}.weight"] = _oihw(_get(params, ["connect", head,
                                                        "kernel"]))
        sd[f"{cm}.{head}.bias"] = _t(_get(params, ["connect", head, "bias"]))

    sd[f"{cm}.adjust"] = _t(_get(params, ["connect", "adjust"]).reshape(1))
    sd[f"{cm}.bias"] = _t(_get(params, ["connect", "bias"])
                          .transpose(0, 3, 1, 2))  # (1,1,1,4) -> (1,4,1,1)
    return sd
