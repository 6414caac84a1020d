"""Model entry points used by the tracker.

Counterpart of `usot_tpu/tracker/runner.py`: the same host API (numpy
images in; features stay on the device; response maps come back as
float64 numpy), run eagerly under `torch.inference_mode()`. The model
runs in its compute dtype (`USOTNet.dtype`), as JAX's runner does:
images go in as float32 and the stem casts them; features come back in
the compute dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.models.usot import USOTNet


class ModelRunner:
    """Host-facing handle on a USOTNet placed on one device.

    weights: None (use the model's own), a state dict in the reference
    layout (tensors or numpy), or another module whose state is copied.
    device: default the GPU; raises without one unless device="cpu"."""

    def __init__(self, model: USOTNet, weights=None, device=None,
                 mem_queue_size: int = 7):
        self.device = resolve_device(device)
        if isinstance(weights, torch.nn.Module):
            weights = weights.state_dict()
        if weights is not None:
            model.load_state_dict(weights)
        self.model = model.to(self.device).eval().cast_weights()
        self.mem_queue_size = mem_queue_size

    def _images(self, x_bhwc) -> torch.Tensor:
        x = np.ascontiguousarray(x_bhwc, dtype=np.float32)
        return torch.from_numpy(x).to(self.device)

    def _boxes(self, boxes) -> torch.Tensor:
        return torch.as_tensor(np.asarray(boxes, np.float32).reshape(-1, 4),
                               device=self.device)

    @staticmethod
    def _maps(cls, bbox, cls_mem=None):
        out = [torch.sigmoid(cls[0, :, :, 0]), bbox[0].permute(2, 0, 1)]
        if cls_mem is not None:
            out.append(torch.sigmoid(cls_mem[0, :, :, 0]))
        return tuple(t.double().cpu().numpy() for t in out)

    # -- host API --

    @torch.inference_mode()
    def template(self, z_hwc: np.ndarray, template_bbox):
        return self.model.template_features(
            self._images(np.asarray(z_hwc)[None]), self._boxes(template_bbox))

    @torch.inference_mode()
    def search_features(self, x_hwc: np.ndarray):
        return self.model.search_features(
            self._images(np.asarray(x_hwc)[None]))

    @torch.inference_mode()
    def track_offline(self, xf, zf):
        """-> (sigmoid cls (S, S), bbox (4, S, S)) float64 numpy."""
        return self._maps(*self.model.track_offline(xf, zf))

    @torch.inference_mode()
    def track_memory(self, xf, zf, mem):
        """-> (sigmoid cls, bbox (4, S, S), sigmoid memory cls) float64."""
        return self._maps(*self.model.track_memory(xf, zf, mem))

    @torch.inference_mode()
    def encode_template(self, zf):
        """Kernel-side encodings of zf: (cls_z 3-tuple, reg_z 3-tuple)."""
        return self.model.encode_template(zf)

    @torch.inference_mode()
    def encode_memory_kernels(self, feat):
        """(N, 7, 7, C) pooled memory features -> 3 cls-side encodings."""
        return self.model.encode_memory_kernels(feat)

    @torch.inference_mode()
    def extract_memory_feature(self, x_hwc=None, xf=None, search_bbox=None):
        if xf is None:
            xf = self.search_features(x_hwc)
        return self.model.pool_memory_feature(xf, self._boxes(search_bbox))

    # -- batched variants --

    @torch.inference_mode()
    def template_batch(self, z_bhwc: np.ndarray, template_bbox_b4):
        return self.model.template_features(self._images(z_bhwc),
                                            self._boxes(template_bbox_b4))

    @torch.inference_mode()
    def extract_memory_feature_batch(self, x_bhwc: np.ndarray,
                                     search_bbox_b4):
        xf = self.model.search_features(self._images(x_bhwc))
        return self.model.pool_memory_feature(xf,
                                              self._boxes(search_bbox_b4))
