"""Flow inference: adaptive frame-interval flow estimation and box
mining for whole videos (counterpart of
`usot_tpu/preprocessing/inference.py`; ref:
preprocessing/flow_module/inference.py).

PWCLite runs in 3-frame mode at a fixed test shape (384x640 by default)
on the device; the adaptive T_f loop re-invokes it with different frame
triples (interval in [1, 7], shrinking when max|flow| > 16 and growing
when < 8, one direction switch per frame). Each frame is uploaded as
uint8, resized on the device (`cv2.resize`'s INTER_LINEAR on float32,
`data/cvops.resize_linear`) and kept there at the test shape: the
full-size frames are not held (JAX's copy holds them all as float32).
Each forward ends in one host read of max|flow|; the flow the loop
keeps is resized to the frame's size on the device and copied to the
host for `flow_to_bbox`.
"""
from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np
import torch

from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.data.cvops import resize_linear
from usot_tpu_torch.data.imageio import read_image
from usot_tpu_torch.models.convert import strip_prefix
from usot_tpu_torch.preprocessing.flow2box import (calc_corner_bbox_freq,
                                                   calc_nearby_bbox_freq,
                                                   flow_to_bbox,
                                                   smooth_bbox_dp)
from usot_tpu_torch.preprocessing.pwclite import (PWCLite, init_pwclite,
                                                  resize_flow)

MAX_INTERVAL = 7
SHRINK_ABOVE, GROW_BELOW = 16, 8  # max|flow| in pixels of the frame


def next_interval(abs_max: float, adjacent: int, direction: int):
    """The adaptive loop's rule: (interval, direction) of the next forward
    for a flow of `abs_max` px at `adjacent`, or None to keep this flow.
    Shrink above 16 px, grow below 8, within [1, 7], and never back
    against the direction taken (-1 shrinking, 1 growing, 0 neither)."""
    if abs_max > SHRINK_ABOVE and adjacent >= 2 and direction <= 0:
        return adjacent - 1, -1
    if abs_max < GROW_BELOW and adjacent <= MAX_INTERVAL - 1 \
            and direction >= 0:
        return adjacent + 1, 1
    return None


class FlowHelper:
    """PWCLite (3 frames, reduce estimator, upsampled) on `device` (the
    GPU unless `device="cpu"`; raises without one) with `variables` (a
    state dict in ARFlow's layout) or, if None, flax's init drawn from
    `generator` (seed 0 if None)."""

    def __init__(self, variables=None, test_shape=(384, 640), device=None,
                 generator=None):
        self.device = resolve_device(device)
        self.test_shape = tuple(test_shape)
        self.model = PWCLite(n_frames=3, reduce_dense=True, upsample=True)
        if variables is None:
            init_pwclite(self.model, generator)
        else:
            self.model.load_state_dict(variables)
        self.model.to(self.device).eval()

    def preprocess(self, img: np.ndarray) -> torch.Tensor:
        """An RGB (H, W, 3) uint8 or float32 frame -> (3, h, w) float32 in
        [0, 1] at the test shape, on the device."""
        h, w = self.test_shape
        x = torch.from_numpy(np.ascontiguousarray(img)).to(self.device)
        x = x.permute(2, 0, 1)[None].float()
        if x.shape[2:] != (h, w):
            x = resize_linear(x, h, w)
        return x[0] / 255.0

    @torch.no_grad()
    def forward(self, pre: List[torch.Tensor], lo: int, i: int, hi: int):
        """The forward flow of frame i -> hi (backward neighbour lo) at the
        test shape, (1, 2, h, w)."""
        triple = torch.cat([pre[lo], pre[i], pre[hi]], 0)[None]
        return self.model(triple)["flows_fw"][0]

    def run_sequence(self, imgs, size: Tuple[int, int], gap: int = 3,
                     init_adjacent: int = 4, decisions=None):
        """imgs: RGB frames (any iterable); size: (H, W) original
        resolution for the output flow maps. Returns the list of (H, W, 2)
        float32 flows, one per sampled frame. `decisions`, a list, receives
        (frame, interval, max|flow|) of every forward."""
        pre = [self.preprocess(im) for im in imgs]
        flows = []
        adjacent = init_adjacent
        H, W = size
        for i in range(gap, len(pre) - gap, gap):
            direction = 0
            while True:
                lo = max(0, i - adjacent)
                hi = min(i + adjacent, len(pre) - 1)
                flow = resize_flow(self.forward(pre, lo, i, hi), H, W)
                abs_max = float(flow.abs().amax())  # the host sync
                if decisions is not None:
                    decisions.append((i, adjacent, abs_max))
                step = next_interval(abs_max, adjacent, direction)
                if step is None:
                    break
                adjacent, direction = step
            flows.append(flow[0].permute(1, 2, 0).cpu().numpy())
        return flows


def load_arflow_checkpoint(path: str, helper: FlowHelper):
    """Load ARFlow's `pwclite_ar_mv.tar` (a torch file holding
    {"state_dict": {"module.<key>": tensor}} or the bare state dict) into
    `helper`'s model, strictly."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    helper.model.load_state_dict(strip_prefix(ckpt))


def inference_sequence(helper: FlowHelper, image_list, gap=3,
                       init_adjacent=4, rng=None, decisions=None,
                       reader=None):
    """Full pseudo-label mining for one video (ref: inference.py:117-170).
    `image_list`: frames as `reader` takes them (default
    `imageio.read_image`: paths or BGR uint8 arrays), each read when the
    loop reaches it; `rng`: the DP's perturbation generator
    (`smooth_bbox_dp`); `decisions`: as `FlowHelper.run_sequence`'s."""
    reader = reader or read_image

    def rgb(src):
        im = reader(src)
        if im is None:
            raise ValueError(f"cannot read frame {src!r}")
        return im[..., ::-1]

    first = rgb(image_list[0])
    h, w = first.shape[:2]
    imgs = itertools.chain([first], (rgb(s) for s in image_list[1:]))
    flows = helper.run_sequence(imgs, size=(h, w), gap=gap,
                                init_adjacent=init_adjacent,
                                decisions=decisions)
    cut_ratio = 1 / 32
    bboxs = [flow_to_bbox(flow, cut_ratio=cut_ratio) for flow in flows]
    bboxs, picked_frame_index, bbox_found_freq, bbox_picked_freq, aver_vary = \
        smooth_bbox_dp(bboxs, length=len(image_list), gap=gap, rng=rng)
    freq_dict = calc_nearby_bbox_freq(picked_frame_index,
                                      video_length=len(bboxs),
                                      search_range=[3, 10], gap=gap)
    corner_bbox_freq = calc_corner_bbox_freq(bboxs, img_shape=(h, w),
                                             cut_ratio=cut_ratio)
    return bboxs, picked_frame_index, (freq_dict, bbox_found_freq,
                                       bbox_picked_freq, aver_vary,
                                       corner_bbox_freq)
