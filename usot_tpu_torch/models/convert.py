"""Weight bridge into the port's reference-layout state dict.

Counterpart of `usot_tpu/models/convert.py:23-314`; training's
`load_pretrain` takes a full USOT `.pth` or a backbone-only ImageNet /
MoCo pretrain (`convert_backbone_pretrain`). The port's modules
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

The flow network's flax variables load through
`pwclite_state_dict_from_flax` (ARFlow's key layout).

`num_batches_tracked` is not written: the port's BatchNorm keeps the
buffer registered, and a missing entry loads with strict=True.
"""
from __future__ import annotations

import re
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



def pwclite_state_dict_from_flax(variables) -> Dict[str, torch.Tensor]:
    """flax variables of `usot_tpu`'s `PWCLite` ({'params': ...}, numpy
    trees) -> state dict of the port's `PWCLite`, in ARFlow's key layout
    (the inverse of `usot_tpu/preprocessing/inference.py:88-127`): HWIO
    kernels to OIHW weights, biases as they are. The estimator's last
    conv is `predict_flow` (reduce) or `conv_last` (dense), whichever the
    tree has."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, path):
        sd[key + ".weight"] = _oihw(_get(params, path + ["conv", "kernel"]))
        sd[key + ".bias"] = _t(_get(params, path + ["conv", "bias"]))

    for lvl in range(6):
        for j, half in enumerate("ab"):
            put(f"feature_pyramid_extractor.convs.{lvl}.{j}.0",
                ["feature_pyramid_extractor", f"level{lvl}_{half}"])
    for name in params["flow_estimators"]:
        put(f"flow_estimators.{name}.0", ["flow_estimators", name])
    for i in range(7):
        put(f"context_networks.convs.{i}.0", ["context_networks", f"c{i}"])
    for i in range(5):
        put(f"conv_1x1.{i}.0", [f"conv1x1_{i}"])
    return sd

def _backbone_convbns():
    """(conv key, bn key) of every conv+BN pair of the backbone, in the
    reference layout."""
    pre = "features.features."
    pairs = [(pre + "conv1.weight", pre + "bn1")]
    for layer, blocks in _LAYER_BLOCKS.items():
        for i in range(blocks):
            tb = f"{pre}{layer}.{i}."
            pairs += [(tb + f"conv{j}.weight", tb + f"bn{j}")
                      for j in (1, 2, 3)]
            pairs.append((tb + "downsample.0.weight", tb + "downsample.1"))
    return pairs


def convert_backbone_pretrain(sd: Dict, state: Dict) -> Dict:
    """Backbone-only ImageNet / MoCo-v2 pretrain merged into `state` (the
    model's state dict); counterpart of `usot_tpu/models/convert.py:
    257-305`. Returns a new state dict.

    MoCo keys look like `encoder_q.conv1.weight` (or `backbone.…`);
    canonical torchvision keys like `conv1.weight`. A 1x1 downsample is
    zero-padded into this architecture's 3x3 slot (ref:
    train_utils.py:109-124). Only backbone conv+BN pairs present in `sd`
    are replaced (`layer4`, `fc` and `num_batches_tracked` are ignored);
    everything else keeps `state`'s value."""
    remapped = {"features.features." + re.sub(r"^(encoder_q\.|backbone\.)",
                                              "", k): v
                for k, v in sd.items()}
    out = dict(state)
    for conv_key, bn_key in _backbone_convbns():
        if conv_key not in remapped or conv_key not in state:
            continue
        w = torch.as_tensor(np.asarray(remapped[conv_key]))
        if w.shape[2] == 1 and state[conv_key].shape[2] == 3:
            padded = torch.zeros(tuple(w.shape[:2]) + (3, 3), dtype=w.dtype)
            padded[:, :, 1:2, 1:2] = w
            w = padded
        out[conv_key] = w
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn_key}.{name}"] = torch.as_tensor(
                np.asarray(remapped[f"{bn_key}.{name}"]))
    return out


def load_pretrain(model, path: str):
    """Load `pretrain/<PRETRAIN>` into `model` in place (ref:
    train_utils.py:92-128): a full USOT checkpoint (`connect_model.`
    keys) loads whole, strictly; a backbone pretrain goes through
    `convert_backbone_pretrain`. Either may nest its state dict under
    "state_dict" and carry `module.`-style prefixes."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    sd = strip_prefix(ckpt)
    if not any(k.startswith("connect_model.") for k in sd):
        sd = convert_backbone_pretrain(sd, model.state_dict())
    model.load_state_dict(sd)
    return model
