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


class Patcher(contextlib.ExitStack):
    """A patcher whose swaps are undone on leaving its block."""

    def setattr(self, target, name, value):
        self.enter_context(mock.patch.object(target, name, value))
