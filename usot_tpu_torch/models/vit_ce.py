"""OSTrack's one-stream ViT backbone with candidate elimination
(`lib/models/ostrack/vit_ce.py` and `utils.py` of github.com/botaoye/
OSTrack; Ye et al., ECCV 2022, arXiv 2203.11991).

Template and search crops are patch-embedded, each plus its own position
table, and their tokens run through every block together. In the blocks
of `ce_loc` (candidate elimination), after the attention and its
residual add, the template centre token's attention row (softmax over
all the block's tokens, mean over heads; `ops.attention`'s side
computation, the fused attention returning no probabilities) ranks the
search tokens, and only the top ceil(keep * L_s), in ranked order, go on
to the MLP and the later blocks. After the final LayerNorm the kept
search tokens are scattered back to their grid positions, zeros where
tokens were dropped. Beside them the backbone gives, for each grid
position, the number of CE stages that kept it (OSTrack's
`removed_indexes_s`, as one map). Token counts depend on the sizes
alone, so every step has static shapes, and the sort and gathers stay
on the device.

Parameter names are those of OSTrack's `backbone.*` state dict. Numerics
follow `layers.py`: float32 parameters, every layer computing in the
dtype of its input (bfloat16 or float32), the parameters cast once and
kept (`cast_param`).

`ce_kept_counts()` counts the search tokens each CE stage kept, summed
over lanes and calls: a host counter like `ops.xcorr_kernel.
launch_counts()`, known from shapes, so it reads nothing back.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from usot_tpu_torch.models.layers import Conv2d, cast_param
from usot_tpu_torch.ops.attention import attention_with_row
from usot_tpu_torch.utils.profiling import span

LN_EPS = 1e-6

_kept: list = []


def ce_kept_counts() -> list:
    """Search tokens kept at each CE stage so far, summed over lanes and
    calls (one entry per stage that has run)."""
    return list(_kept)


def reset_ce_kept_counts():
    _kept.clear()


def _count(stage: int, tokens: int):
    while len(_kept) <= stage:
        _kept.append(0)
    _kept[stage] += tokens


class Linear(nn.Linear):
    """nn.Linear in the dtype of its input."""

    def forward(self, x):
        return F.linear(x, cast_param(self, "weight", x.dtype),
                        cast_param(self, "bias", x.dtype))


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm (eps 1e-6) in the dtype of its input."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            cast_param(self, "weight", x.dtype),
                            cast_param(self, "bias", x.dtype), self.eps)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch, bias=True)

    def forward(self, img):
        """(B, 3, H, W) -> (B, H W / patch^2, C)."""
        return self.proj(img).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, row=None):
        """x (B, N, C) -> (output (B, N, C), query `row`'s probabilities
        averaged over heads (B, N) float32, or None without a row)."""
        b, n, c = x.shape
        q, k, v = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads) \
            .permute(2, 0, 3, 1, 4).unbind(0)
        if row is None:
            out, probs = F.scaled_dot_product_attention(q, k, v), None
        else:
            out, probs = attention_with_row(q, k, v, row)
        return self.proj(out.transpose(1, 2).reshape(b, n, c)), probs


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class CEBlock(nn.Module):
    """A pre-norm block; `stage` (its CE stage, or None) and `keep`
    (the share of search tokens it keeps) make it eliminate."""

    def __init__(self, dim: int, heads: int, hidden: int, keep: float = 1.0,
                 stage: int | None = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, hidden)
        self.keep, self.stage = keep, stage

    def forward(self, x, index, lens_t: int, centre: int):
        """x (B, lens_t + L_s, C), index (B, L_s) the search tokens' grid
        positions -> both after the block."""
        out, row = self.attn(self.norm1(x),
                             centre if self.stage is not None else None)
        x = x + out
        if self.stage is not None:
            with span("vit.ce"):
                x, index = self.eliminate(x, row, index, lens_t)
        return x + self.mlp(self.norm2(x)), index

    def eliminate(self, x, row, index, lens_t: int):
        """OSTrack's `candidate_elimination` on the centre row `row`."""
        b, n, c = x.shape
        keep = math.ceil(self.keep * (n - lens_t))
        top = torch.sort(row[:, lens_t:], dim=1,
                         descending=True).indices[:, :keep]
        kept = x[:, lens_t:].gather(1, top[..., None].expand(-1, -1, c))
        _count(self.stage, b * keep)
        return torch.cat([x[:, :lens_t], kept], dim=1), index.gather(1, top)


class VisionTransformerCE(nn.Module):
    """OSTrack's backbone. `pos_embed_z` / `pos_embed_x` are the template's
    and the search crop's position tables (OSTrack derives them from the
    MAE `pos_embed` when it builds the model and stores them)."""

    def __init__(self, dim: int = 768, depth: int = 12, heads: int = 12,
                 hidden: int = 3072, patch: int = 16, template: int = 192,
                 search: int = 384, ce_loc=(3, 6, 9), keep: float = 0.7):
        super().__init__()
        self.patch_embed = PatchEmbed(dim, patch)
        t, f = template // patch, search // patch
        self.pos_embed_z = nn.Parameter(torch.zeros(1, t * t, dim))
        self.pos_embed_x = nn.Parameter(torch.zeros(1, f * f, dim))
        ce_loc = tuple(ce_loc)
        self.blocks = nn.ModuleList(
            CEBlock(dim, heads, hidden,
                    keep if i in ce_loc else 1.0,
                    ce_loc.index(i) if i in ce_loc else None)
            for i in range(depth))
        self.norm = LayerNorm(dim)
        # the template's centre token (OSTrack's CTR_POINT mask): row and
        # column (t - 1) // 2 of its t x t grid
        self.centre = (t - 1) // 2 * t + (t - 1) // 2
        self.feat_sz = f

    def embed(self, img, which: str):
        """Normalised images (B, 3, H, W) in the compute dtype -> tokens
        plus the position table of `which` ("z" or "x")."""
        return self.patch_embed(img) + cast_param(self, f"pos_embed_{which}",
                                                  img.dtype)

    def forward(self, z_tokens, x_tokens):
        """Template tokens (B, T, C) and search tokens (B, F*F, C) -> (the
        search tokens after the final norm at their grid positions
        (B, F*F, C), zero where eliminated; the CE stages that kept each
        grid position (B, F*F) uint8, len(ce_loc) where none dropped
        it)."""
        lens_t, lens_x = z_tokens.shape[1], x_tokens.shape[1]
        x = torch.cat([z_tokens, x_tokens], dim=1)
        b, _, c = x.shape
        index = torch.arange(lens_x, device=x.device).expand(b, -1)
        passed = torch.zeros((b, lens_x), dtype=torch.uint8, device=x.device)
        for blk in self.blocks:
            x, index = blk(x, index, lens_t, self.centre)
            if blk.stage is not None:
                passed.scatter_(1, index, blk.stage + 1)
        x = self.norm(x)
        full = x.new_zeros((b, lens_x, c))
        return full.scatter_(1, index[..., None].expand(-1, -1, c),
                             x[:, lens_t:]), passed
