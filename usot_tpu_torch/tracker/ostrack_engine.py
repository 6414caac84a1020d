"""OSTrack's tracker (`lib/test/tracker/ostrack.py` of github.com/botaoye/
OSTrack) as a batch engine: B videos in lockstep on the device, on the
lane machinery `BatchScanEngine` runs on (`engine.LaneEngine`: the first
frames up in one copy, chunks made on the host or staged on the device,
`FrameLoop`'s chunk loop, one read-back per call).

The carry is the lanes' boxes, [x, y, w, h] in float64 as OSTrack's
Python floats, and their template tokens; each lane's image size rides
beside it, as in `BatchScanEngine`. There is no memory queue, no
scale penalty and no size EMA, and the template is never updated:
`init_batch` crops each lane's template (factor 2.0) on the device and
embeds it once, and its tokens join every frame's forward (the stream
is one). A frame step, all on the device, with no host sync: the search
crop (factor 5.0, `core.crop.sample_target_gather`), ImageNet's
normalisation, the model (`models/ostrack.py`, its head folded once),
and the decode: the score map times a centred Hann window, its argmax
cell, the box ((x + off_x) / F, (y + off_y) / F, w, h) of the crop,
scaled to the frame by the crop, mapped back around the previous box's
centre and clipped (OSTrack's `clip_box`, margin 10). The outputs per
frame are the box's centre and size (float64), the raw score at the
chosen cell (float32), and the CE stages that kept each search position
(uint8, `VisionTransformerCE.forward`), which the benchmark's check
holds against the reference's own elimination.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from usot_tpu_torch.core.crop import sample_target_gather
from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.models.ostrack import OSTrack, fold_center_head
from usot_tpu_torch.tracker.engine import LaneEngine
from usot_tpu_torch.utils.profiling import span

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
MARGIN = 10
# OSTrack's test parameters (`lib/test/parameter/ostrack.py`)
TEMPLATE_FACTOR = 2.0
SEARCH_FACTOR = 5.0


class OSTrackState(NamedTuple):
    box: Any        # (B, 4) float64 [x, y, w, h]
    z_tokens: Any   # (B, T, C) the templates' tokens, compute dtype


def hann2d(n: int) -> torch.Tensor:
    """OSTrack's centred 2-D Hann window (n, n), float32."""
    h = 0.5 * (1 - torch.cos((2 * math.pi / (n + 1))
                             * torch.arange(1, n + 1).float()))
    return h[:, None] * h[None, :]


def _freeze_box(new: OSTrackState, old: OSTrackState, is_valid):
    return new._replace(box=torch.where(is_valid[:, None], new.box, old.box))


class OSTrackBatchEngine(LaneEngine):
    """OSTrack over B lanes; each lane's image lies at the top-left of the
    frames' canvas, its (h, w) given at `init_batch`.

    model: an `OSTrack` with its weights; device None means the GPU
    (raises without one unless device="cpu")."""

    _freeze = staticmethod(_freeze_box)

    def __init__(self, model: OSTrack, batch: int, chunk: int = 32,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch, self.chunk = batch, chunk
        self.folded = fold_center_head(model.box_head, model.dtype)
        self.window = hann2d(model.feat_sz).to(self.device)
        self._mean = torch.tensor(MEAN, device=self.device)
        self._std = torch.tensor(STD, device=self.device)
        self._im_hw_b = None
        # `init_batch` calls so far: the round ordinal the spans carry
        self.rounds = 0

    def _normalise(self, crops):
        """(B, S, S, 3) whole grey levels -> (B, 3, S, S) float32 on
        ImageNet's mean and std (OSTrack's `Preprocessor`)."""
        return ((crops / 255.0 - self._mean) / self._std).permute(0, 3, 1, 2)

    @torch.inference_mode()
    def init_batch(self, videos, runner=None) -> OSTrackState:
        """videos: list of (first_frame (h, w, 3) uint8, target_pos
        (cx, cy), target_sz (w, h)), one per lane. `runner` is not used
        (the signature of `BatchScanEngine.init_batch`)."""
        if len(videos) != self.batch:
            raise ValueError(f"{len(videos)} videos for a batch of "
                             f"{self.batch}")
        self.rounds += 1
        with span("engine.init_batch", self.rounds):
            with span("engine.init_host"):
                boxes = np.array([[p[0] - s[0] / 2, p[1] - s[1] / 2, s[0],
                                   s[1]] for _, p, s in videos], np.float64)
                frames = self._upload_first([im for im, _, _ in videos])
                self._im_hw_b = torch.as_tensor(
                    [im.shape[:2] for im, _, _ in videos],
                    dtype=torch.float64).to(self.device, non_blocking=True)
                box = torch.as_tensor(boxes).to(self.device,
                                                non_blocking=True)
            z, _ = sample_target_gather(frames, box, TEMPLATE_FACTOR,
                                        self.model.template_size,
                                        self._im_hw_b)
            z_tokens = self.model.embed_template(self._normalise(z))
        return OSTrackState(box, z_tokens)

    def run_chunk(self, state: OSTrackState, block, valid):
        """One chunk on (T, B, H, W, 3) uint8 frames and (T, B) validity,
        both on the device. Makes no host synchronisation. Returns (state,
        (pos (T, B, 2), sz (T, B, 2), score (T, B), CE stages (T, B,
        F*F))) on the device."""
        return self._chunk(state, block, valid, self._im_hw_b)

    def _frame_step_batched(self, carry: OSTrackState, frames, is_valid,
                            im_hw_b):
        """One frame of every lane. Returns (new carry, (pos, sz, score,
        CE stages))."""
        model = self.model
        with span("engine.crop"):
            crops, crop_sz = sample_target_gather(
                frames, carry.box, SEARCH_FACTOR, model.search_size,
                im_hw_b)
            x = self._normalise(crops)
        score, size, offset, passed = model(carry.z_tokens, x, self.folded)
        with span("engine.post"):
            box, best = self._decode(carry.box, crop_sz, score, size, offset,
                                     im_hw_b)
        return (OSTrackState(box, carry.z_tokens),
                (box[:, :2] + 0.5 * box[:, 2:], box[:, 2:], best, passed))

    def _decode(self, box, crop_sz, score, size, offset, im_hw):
        """OSTrack's `track` after the forward, for B lanes: (new boxes
        (B, 4) float64, the raw score at each chosen cell (B,))."""
        b, f = box.shape[0], self.model.feat_sz
        s = float(self.model.search_size)
        cell = (score[:, 0] * self.window).reshape(b, -1).argmax(dim=1)

        def at(m):
            return m.reshape(b, m.shape[1], -1).gather(
                2, cell[:, None, None].expand(-1, m.shape[1], 1))[..., 0]
        wh, off = at(size), at(offset)
        cx = ((cell % f).float() + off[:, 0]) / f
        cy = ((cell // f).float() + off[:, 1]) / f
        resize = s / crop_sz                                  # float64
        pred = (torch.stack([cx, cy, wh[:, 0], wh[:, 1]], -1) * s
                / resize.float()[:, None]).double()
        half = 0.5 * s / resize
        cx = pred[:, 0] + (box[:, 0] + 0.5 * box[:, 2] - half)
        cy = pred[:, 1] + (box[:, 1] + 0.5 * box[:, 3] - half)
        x1, y1 = cx - 0.5 * pred[:, 2], cy - 0.5 * pred[:, 3]
        x2, y2 = x1 + pred[:, 2], y1 + pred[:, 3]
        hh, ww = im_hw[:, 0], im_hw[:, 1]
        x1 = torch.minimum(torch.clamp(x1, min=0.0), ww - MARGIN)
        x2 = torch.minimum(torch.clamp(x2, min=float(MARGIN)), ww)
        y1 = torch.minimum(torch.clamp(y1, min=0.0), hh - MARGIN)
        y2 = torch.minimum(torch.clamp(y2, min=float(MARGIN)), hh)
        new = torch.stack([x1, y1, torch.clamp(x2 - x1, min=float(MARGIN)),
                           torch.clamp(y2 - y1, min=float(MARGIN))], -1)
        return new, score.reshape(b, -1).gather(1, cell[:, None])[:, 0]
