"""OSTrack (Ye et al., "Joint Feature Learning and Relation Modeling for
Tracking: A One-Stream Framework", ECCV 2022, arXiv 2203.11991;
github.com/botaoye/OSTrack `lib/models/ostrack/ostrack.py`,
`lib/models/layers/head.py`): the ViT backbone with candidate elimination
(`vit_ce.py`) and the centre head, at OSTrack-384's published sizes by
default (`experiments/ostrack/vitb_384_mae_ce_32x4_ep300.yaml`: ViT-B/16,
192-px template, 384-px search, CE in blocks 3, 6, 9 keeping 0.7, head
channels 256).

Parameter names are those of OSTrack's `net` state dict (`backbone.*`,
`box_head.conv{1..5}_{ctr,offset,size}`), so its checkpoint loads by key
(`load_ostrack_state`). The head's conv-BN-ReLU layers are `layers.ConvBN`
(BN eps 1e-5); `fold_center_head` folds their eval BN into the convs
once, and the tracker runs the folded head.

Numerics: float32 parameters; the model computes in `dtype` (bfloat16 or
float32, `layers.compute_dtype`), and the head's maps come out float32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from usot_tpu_torch.models.head import _fold_conv_bn
from usot_tpu_torch.models.layers import Conv2d, ConvBN
from usot_tpu_torch.models.vit_ce import VisionTransformerCE
from usot_tpu_torch.utils.profiling import span

BRANCHES = (("ctr", 1), ("offset", 2), ("size", 2))
# OSTrack checkpoint keys the tracker never reads: MAE's own position
# table and class token, from which OSTrack built `pos_embed_z/x`
UNUSED_KEYS = ("backbone.pos_embed", "backbone.cls_token")


def _sigmoid(x):
    return torch.clamp(torch.sigmoid(x.float()), min=1e-4, max=1 - 1e-4)


class CenterPredictor(nn.Module):
    """OSTrack's centre head: per branch (score `ctr`, `offset`, `size`)
    four 3x3 conv-BN-ReLU layers (inplanes -> c -> c/2 -> c/4 -> c/8) and
    a 1x1 conv."""

    def __init__(self, inplanes: int = 768, channel: int = 256):
        super().__init__()
        for branch, out in BRANCHES:
            cin = inplanes
            for k in range(1, 5):
                cout = channel // 2 ** (k - 1)
                setattr(self, f"conv{k}_{branch}",
                        ConvBN(cin, cout, 3, padding=1, bias=True, relu=True))
                cin = cout
            setattr(self, f"conv5_{branch}", Conv2d(cin, out, 1))

    def forward(self, x, folded=None):
        """The search map (B, C, F, F) -> (score (B, 1, F, F), size (B, 2,
        F, F), offset (B, 2, F, F)), float32. folded: `fold_center_head`'s
        weights in the compute dtype, or None (the modules' own, BN in
        eval mode)."""
        out = {}
        for branch, _ in BRANCHES:
            y = x
            if folded is None:
                for k in range(1, 5):
                    y = getattr(self, f"conv{k}_{branch}")(y)
                out[branch] = getattr(self, f"conv5_{branch}")(y)
            else:
                layers = folded[branch]
                for w, b in layers[:-1]:
                    y = F.relu(F.conv2d(y, w, b, padding=1))
                out[branch] = F.conv2d(y, *layers[-1])
        return (_sigmoid(out["ctr"]), _sigmoid(out["size"]),
                out["offset"].float())


@torch.no_grad()
def fold_center_head(head: CenterPredictor, dtype=torch.float32) -> dict:
    """{branch: [(W, b)] * 5}: each conv-BN-ReLU layer's eval BN folded
    into its conv (in float32, then cast to `dtype`), the 1x1 conv last.
    The kernels are kept channels-last, the layout the head's input has
    (the backbone's tokens viewed as a map) and cuDNN's for bfloat16."""
    folded = {}
    for branch, _ in BRANCHES:
        layers = [_fold_conv_bn(getattr(head, f"conv{k}_{branch}"))
                  for k in range(1, 5)]
        last = getattr(head, f"conv5_{branch}")
        layers.append((last.weight.float(), last.bias.float()))
        folded[branch] = [
            (w.to(dtype).contiguous(memory_format=torch.channels_last),
             b.to(dtype)) for w, b in layers]
    return folded


class OSTrack(nn.Module):
    """Backbone and head. `dtype`: the compute dtype."""

    def __init__(self, dim: int = 768, depth: int = 12, heads: int = 12,
                 hidden: int = 3072, patch: int = 16, template: int = 192,
                 search: int = 384, head_channels: int = 256,
                 ce_loc=(3, 6, 9), keep: float = 0.7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = VisionTransformerCE(dim, depth, heads, hidden, patch,
                                            template, search, ce_loc, keep)
        self.box_head = CenterPredictor(dim, head_channels)
        self.template_size, self.search_size = template, search
        self.feat_sz = search // patch
        self.dtype = dtype

    def embed_template(self, z):
        """Normalised template images (B, 3, T, T) float32 -> template
        tokens (B, (T/16)^2, C) in the compute dtype."""
        return self.backbone.embed(z.to(self.dtype), "z")

    def forward(self, z_tokens, x, folded=None):
        """Template tokens and normalised search images (B, 3, S, S)
        float32 -> (score, size, offset) maps, float32 (see
        `CenterPredictor.forward`), and the CE stages that kept each
        search position (B, F*F) uint8 (`VisionTransformerCE.forward`)."""
        with span("vit.embed"):
            x_tokens = self.backbone.embed(x.to(self.dtype), "x")
        with span("vit.blocks"):
            tokens, passed = self.backbone(z_tokens, x_tokens)
        with span("vit.head"):
            b, n, c = tokens.shape
            f = self.feat_sz
            feat = tokens.view(b, f, f, c).permute(0, 3, 1, 2)
            return self.box_head(feat, folded) + (passed,)


def build_ostrack(dtype: torch.dtype = torch.float32, **sizes) -> OSTrack:
    """OSTrack at the published OSTrack-384 sizes, or at `sizes` (the
    keyword arguments of `OSTrack`), computing in `dtype`."""
    return OSTrack(dtype=dtype, **sizes)


@torch.no_grad()
def init_ostrack(model: OSTrack, generator: torch.Generator) -> OSTrack:
    """Seeded weights with OSTrack's own initialisers: truncated normal
    (std 0.02) linear weights and position tables, zero biases, unit
    LayerNorms; the head's convs xavier-uniform, BN at identity."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif "norm" in name or name.endswith(".1.weight"):
            p.fill_(1.0)
        elif name.startswith("box_head"):
            fan_out = p.shape[0] * p[0, 0].numel()
            bound = (6.0 / (p[0].numel() + fan_out)) ** 0.5
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                    * bound)
        else:
            p.copy_(torch.randn(p.shape, generator=generator)
                    .clamp_(-2, 2) * 0.02)
    return model


def load_ostrack_state(model: OSTrack, state: dict) -> OSTrack:
    """Load an OSTrack checkpoint's weights by key: `state` is its `net`
    state dict, or the checkpoint dict holding it under "net". Keys the
    tracker never reads (`UNUSED_KEYS`) are ignored; any other key
    missing or unexpected raises."""
    if "net" in state:
        state = state["net"]
    state = {k: v for k, v in state.items() if k not in UNUSED_KEYS}
    model.load_state_dict(state, strict=True)
    return model
