"""Faults planted in the program under test. Each takes a patcher (an
object with `setattr(target, name, value)`, as `pytest`'s monkeypatch
has) and swaps one piece of the program for a broken one; the cell's
check has to come out not correct over it. The fault tests plant them
on the CPU at small sizes (`tests/test_portbench_faults.py`), and
`python3 -m portbench.controls --variant <fault>` reads them at a
cell's own size on the card.

Tracking, in `BatchScanEngine.track_staged`'s outputs:
* `answer_altered`: every other frame's box centre 12 px off;
* `size_scaled`: every frame's box size 1.1 times (a wrong size
  update);
* `score_shifted`: every frame's score 0.05 higher;
* `chunk_first_frame`: the box centre 12 px off on the first frame of
  each staged chunk alone;
* `chunk_lanes_rolled`: on the first frame of each staged chunk alone,
  each lane reports its neighbour's box and score (an indexing slip at
  the chunk's edge);
and in the model:
* `relu_dropped`: the first ReLU of the backbone's first bottleneck
  left out.

Mining (`MINING`), in the flow network (`preprocessing/pwclite.py`):
* `warp_shifted`: every warp samples 1 px to the right;
* `corr_transposed`: the cost volume's (dy, dx) order transposed;
* `context_dropped`: the context network's residual not added;
on the host (`preprocessing/flow2box.py`, `inference.py`,
`crop_gen.py`):
* `shrink_lowered`: the adaptive loop shrinks the interval above 9 px
  of max|flow|, not 16;
* `grow_raised`: the adaptive loop grows the interval below 16 px of
  max|flow|, not 8 (the shrink threshold put in the growth rule);
* `threshold_raised`: `flow_to_bbox`'s first threshold (`GROUPS[0]`'s
  mean-max ratio) 0.75, not 0.7;
* `dp_reward_flipped`: the DP's reward for a box's agreement with the
  box before it (its modified DIoU) with its sign flipped;
* `crop_shifted`: every crop taken at its box moved 1 px to the right.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import torch.nn.functional as F


def _staged(m, alter):
    """`track_staged` with `alter(pos, sz, score, chunk)` applied to
    copies of its outputs (lanes, frames, ...)."""
    from usot_tpu_torch.tracker.engine import BatchScanEngine

    real = BatchScanEngine.track_staged

    def altered(self, state, staged):
        state, pos, sz, score = real(self, state, staged)
        pos, sz, score = pos.copy(), sz.copy(), score.copy()
        alter(pos, sz, score, staged[0][0])
        return state, pos, sz, score
    m.setattr(BatchScanEngine, "track_staged", altered)


def answer_altered(m):
    def alter(pos, sz, score, chunk):
        pos[:, ::2, 0] += 12.0
    _staged(m, alter)


def size_scaled(m):
    def alter(pos, sz, score, chunk):
        sz *= 1.1
    _staged(m, alter)


def score_shifted(m):
    def alter(pos, sz, score, chunk):
        score += 0.05
    _staged(m, alter)


def chunk_first_frame(m):
    def alter(pos, sz, score, chunk):
        pos[:, ::chunk, 0] += 12.0
    _staged(m, alter)


def chunk_lanes_rolled(m):
    def alter(pos, sz, score, chunk):
        for a in (pos, sz, score):
            a[:, ::chunk] = np.roll(a[:, ::chunk], 1, axis=0)
    _staged(m, alter)


def relu_dropped(m):
    import usot_tpu_torch.models.usot as usot

    real = usot.build_usot

    def build(*a, **k):
        model = real(*a, **k)
        block = model.features.features.layer1[0]

        def forward(x, bn_train):
            out = block.bn1(block.conv1(x), bn_train)
            out = F.relu(block.bn2(block.conv2(out), bn_train))
            out = block.bn3(block.conv3(out), bn_train)
            residual = x if block.downsample is None \
                else block.downsample(x, bn_train)
            return F.relu(out + residual)
        block.forward = forward
        return model
    m.setattr(usot, "build_usot", build)


TRACKING = {f.__name__: f for f in (answer_altered, size_scaled,
                                    score_shifted, chunk_first_frame,
                                    chunk_lanes_rolled, relu_dropped)}


def warp_shifted(m):
    import usot_tpu_torch.preprocessing.pwclite as pwclite

    real = pwclite.flow_warp

    def warp(x, flow):
        return real(x, flow + flow.new_tensor([1.0, 0.0])[None, :, None,
                                                         None])
    m.setattr(pwclite, "flow_warp", warp)


def corr_transposed(m):
    import usot_tpu_torch.preprocessing.pwclite as pwclite

    real = pwclite.correlation

    def correlation(x1, x2, d=4):
        out = real(x1, x2, d)
        b, k, h, w = out.shape
        n = 2 * d + 1
        return out.view(b, n, n, h, w).transpose(1, 2).reshape(b, k, h, w)
    m.setattr(pwclite, "correlation", correlation)


def context_dropped(m):
    import usot_tpu_torch.preprocessing.pwclite as pwclite

    m.setattr(pwclite.ContextNetwork, "forward",
              lambda self, x: self.convs(x) * 0.0)


def shrink_lowered(m):
    import usot_tpu_torch.preprocessing.inference as inference

    m.setattr(inference, "SHRINK_ABOVE", 9)


def grow_raised(m):
    import usot_tpu_torch.preprocessing.inference as inference

    m.setattr(inference, "GROW_BELOW", 16)


def threshold_raised(m):
    import usot_tpu_torch.preprocessing.flow2box as flow2box

    m.setattr(flow2box, "GROUPS", ((0.75, 0.5),) + flow2box.GROUPS[1:])


def dp_reward_flipped(m):
    import usot_tpu_torch.preprocessing.flow2box as flow2box

    real = flow2box.diou_modify
    m.setattr(flow2box, "diou_modify", lambda a, b: -real(a, b))


def crop_shifted(m):
    import usot_tpu_torch.preprocessing.crop_gen as crop_gen

    real = crop_gen.crop_like_siamfc

    def crop(image, bbox, *a, **k):
        return real(image, (bbox[0] + 1, bbox[1], bbox[2] + 1, bbox[3]),
                    *a, **k)
    m.setattr(crop_gen, "crop_like_siamfc", crop)


MINING = {f.__name__: f for f in (warp_shifted, corr_transposed,
                                  context_dropped, shrink_lowered,
                                  grow_raised, threshold_raised,
                                  dp_reward_flipped, crop_shifted)}


class Patcher(contextlib.ExitStack):
    """A patcher whose swaps are undone on leaving its block."""

    def setattr(self, target, name, value):
        self.enter_context(mock.patch.object(target, name, value))
