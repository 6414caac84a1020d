"""Multi-head attention that also gives one query's softmax row.

OSTrack's candidate elimination reads one row of a block's attention
probabilities: the template centre token's, over every key, averaged
over the heads. A fused attention kernel (`F.scaled_dot_product_attention`
on the card: FlashAttention or cuDNN) returns no probabilities, and
materialising the (N, N) matrix to read one row would throw away most of
what the fused kernel saves. So the row is a side computation: that one
query against all keys, per head, in float32 (what the fused kernel's
own logits and softmax are computed in), softmax over the keys, mean
over the heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def attention_with_row(q, k, v, row: int):
    """q, k, v (B, H, N, D) in the compute dtype -> (the attention output
    (B, H, N, D), the mean over heads of query `row`'s softmax over the N
    keys (B, N) float32)."""
    out = F.scaled_dot_product_attention(q, k, v)
    logits = torch.matmul(k.float(), q[:, :, row, :, None].float())[..., 0]
    probs = torch.softmax(logits * q.shape[-1] ** -0.5, dim=-1)
    return out, probs.mean(dim=1)
