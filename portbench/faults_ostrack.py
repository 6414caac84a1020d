"""Faults planted in the OSTrack program under test (the cell
`track_ostrack384_b64_staged`), each taking a patcher as `faults.py`'s
do; the cell's check has to come out not correct over each:

* `ce_lowest`: candidate elimination keeps the lowest-ranked tokens;
* `ce_row_shifted`: CE ranks by template token 64's row, not the centre
  token's (65 at 12 x 12);
* `dropped_mean`: eliminated positions filled with the kept tokens' mean,
  not zeros;
* `pos_x_transposed`: the search position table read transposed (x for
  y);
* `offset_swapped`: the offset map's x and y swapped;
* `hann_dropped`: the score map's argmax taken without the Hann window.
"""
from __future__ import annotations

import torch


def ce_lowest(m):
    from usot_tpu_torch.models import vit_ce

    real = vit_ce.CEBlock.eliminate
    m.setattr(vit_ce.CEBlock, "eliminate",
              lambda self, x, row, index, lens_t:
              real(self, x, -row, index, lens_t))


def ce_row_shifted(m):
    from usot_tpu_torch.models import vit_ce

    real = vit_ce.VisionTransformerCE.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        self.centre -= 1
    m.setattr(vit_ce.VisionTransformerCE, "__init__", init)


def dropped_mean(m):
    from usot_tpu_torch.models import vit_ce

    real = vit_ce.VisionTransformerCE.forward

    def forward(self, z_tokens, x_tokens):
        out, passed = real(self, z_tokens, x_tokens)
        dropped = (out == 0).all(dim=-1, keepdim=True)
        mean = out.sum(dim=1, keepdim=True) \
            / (~dropped).sum(dim=1, keepdim=True)
        return torch.where(dropped, mean.to(out.dtype), out), passed
    m.setattr(vit_ce.VisionTransformerCE, "forward", forward)


def pos_x_transposed(m):
    from usot_tpu_torch.models import vit_ce

    real = vit_ce.VisionTransformerCE.embed

    def embed(self, img, which):
        out = real(self, img, which)
        if which != "x":
            return out
        pos = self.pos_embed_x.to(out.dtype)
        f, c = self.feat_sz, pos.shape[-1]
        return out - pos + pos.view(1, f, f, c).transpose(1, 2) \
            .reshape(1, f * f, c)
    m.setattr(vit_ce.VisionTransformerCE, "embed", embed)


def offset_swapped(m):
    from usot_tpu_torch.models import ostrack

    real = ostrack.CenterPredictor.forward

    def forward(self, x, folded=None):
        score, size, offset = real(self, x, folded)
        return score, size, offset.flip(1)
    m.setattr(ostrack.CenterPredictor, "forward", forward)


def hann_dropped(m):
    from usot_tpu_torch.tracker import ostrack_engine

    m.setattr(ostrack_engine, "hann2d", lambda n: torch.ones(n, n))


OSTRACK = {f.__name__: f for f in (ce_lowest, ce_row_shifted, dropped_mean,
                                   pos_x_transposed, offset_swapped,
                                   hann_dropped)}
