"""Work counts of the benchmark's cells, from shapes on the reference
network (`reference/net.py`) run on the `meta` device under
`FlopCounterMode`, so the count is the same whatever implements the
work; and the H100's published peaks (NVIDIA's data sheet, SXM, dense).

* `frame_step_flops`: one tracking frame step of `lanes` lanes as the
  tracker computes it with its encodings carried (the template's and
  each memory frame's kernels are encoded once, when made): the search
  crop through backbone and neck, the six search encoders, the offline
  branch (two GroupDW correlations, the towers, the predictors), the
  memory branch over the queue (GroupDW against `queue` kernels,
  confidence-value fusion, its tower and predictor), and the new memory
  frame pooled and encoded. Two operations per multiply-add.
* `train_step_flops`: the cycle-memory training step's forward and
  backward (`reference/train.forward` and the gradients of every
  trainable leaf).
* `k1_calls`: the engine's three fused GroupDW calls of a frame step
  (offline cls and reg at M=1, the memory branch at M=`queue`): their
  operations and the bytes that reading each input once and writing
  the output once moves.
* `flow_forward_flops`: one 3-frame PWCLite forward of the reference
  (`reference/pwclite.py`) at an input size: its convolutions, and its
  cost volumes and warps as it computes them (each shift's product and
  channel mean, one operation an element each; a bilinear sample four
  multiply-adds an output element and channel).
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference.net import ENCODERS, Net, param_shapes, prpool

PEAK_BF16 = 989e12      # dense bf16 on the tensor cores
PEAK_F32 = 67e12        # float32 outside the tensor cores (TF32 off)
PEAK_HBM = 3.35e12      # bytes per second
META = torch.device("meta")


def _meta_net(width: int, channels: int, grad: bool = False) -> Net:
    w = {k: torch.empty(s, device=META)
         for k, s in param_shapes(width, channels).items()}
    if grad:
        for k, t in w.items():
            if not k.endswith(("running_mean", "running_var")):
                t.requires_grad_(True)
    return Net(w, mode="train" if grad else "eval")


def _conv_backward(grad_out_shape, x_shape, w_shape, *args,
                   out_shape=None, **kwargs) -> int:
    """Each gradient a convolution's backward makes costs its forward:
    2 * prod(output) * prod(weight[1:]). torch's own formula for this op
    does not divide a grouped (depthwise) convolution's by its groups."""
    mask = args[-1]
    forward = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward * (int(mask[0]) + int(mask[1]))


def _elementwise(*shapes, out_shape=None, **kwargs) -> int:
    return math.prod(out_shape)


def _reduction(x_shape, *args, out_shape=None, **kwargs) -> int:
    return math.prod(x_shape)


def _bilinear(x_shape, grid_shape, *args, out_shape=None, **kwargs) -> int:
    return 8 * math.prod(out_shape)


def _flops(fn, mapping=None) -> float:
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: _conv_backward,
            **(mapping or {})}) as counter:
        fn()
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def frame_step_flops(width: int, channels: int, lanes: int, queue: int = 7,
                     instance: int = 255) -> float:
    net = _meta_net(width, channels)
    c = channels
    zf = torch.empty((lanes, c, 7, 7), device=META)
    zenc = (net.encode(zf, "cls", "k"), net.encode(zf, "reg", "k"))
    mem = net.encode(torch.empty((lanes * queue, c, 7, 7), device=META),
                     "cls", "k")
    crop = torch.empty((lanes, instance, instance, 3), device=META)
    boxes = torch.empty((lanes, 4), device=META)

    def step():
        xf = net.features(crop)
        cls_x = net.encode(xf, "cls", "s")
        net.offline(zenc[0], zenc[1], cls_x, net.encode(xf, "reg", "s"))
        net.memory(cls_x, mem, queue)
        net.encode(prpool(xf, boxes), "cls", "k")
    return _flops(step)


@functools.lru_cache(maxsize=None)
def train_step_flops(width: int, channels: int, batch: int,
                     mem_num: int) -> float:
    from portbench.reference.train import forward, leaves

    net = _meta_net(width, channels, grad=True)
    names = list(leaves(width, channels))
    b = {"template": torch.empty((batch, 127, 127, 3), device=META),
         "search": torch.empty((batch, 255, 255, 3), device=META),
         "label": torch.empty((batch, 25, 25), device=META),
         "reg_target": torch.empty((batch, 25, 25, 4), device=META),
         "reg_weight": torch.empty((batch, 25, 25), device=META),
         "template_bbox": torch.empty((batch, 4), device=META),
         "search_memory": torch.empty((batch, mem_num, 255, 255, 3),
                                      device=META),
         "search_bbox": torch.empty((batch, 4), device=META)}

    def step():
        cls, mem, reg = forward(net, b, 0.5)
        torch.autograd.grad(0.3 * cls + 0.6 * mem + reg,
                            [net.w[k] for k in names])
    return _flops(step)


def k1_calls(lanes: int, channels: int, queue: int, itemsize: int,
             search_cells: int = 31, kernel_cells: int = 7) -> list:
    """[(flops, bytes)] of the frame step's three GroupDW calls."""
    calls = []
    for m in (1, 1, queue):
        flops = nbytes = 0
        out = None
        for _, (dh, dw) in ENCODERS:
            xh, xw = search_cells - 2 * dh, search_cells - 2 * dw
            kh, kw = kernel_cells - 2 * dh, kernel_cells - 2 * dw
            out = (xh - kh + 1, xw - kw + 1)
            flops += 2 * lanes * m * channels * out[0] * out[1] * kh * kw
            nbytes += (lanes * xh * xw + lanes * m * kh * kw) * channels
        nbytes += lanes * m * out[0] * out[1] * channels
        calls.append((float(flops), float(nbytes * itemsize)))
    return calls


@functools.lru_cache(maxsize=None)
def flow_forward_flops(h: int, w: int) -> float:
    from portbench.reference import pwclite

    weights = {k: torch.empty(s, device=META)
               for k, s in pwclite.param_shapes().items()}
    x = torch.empty((1, 3, h, w), device=META)
    aten = torch.ops.aten
    return _flops(lambda: pwclite.flows_3_frames(weights, x, x, x), {
        aten.mul: _elementwise, aten.mean: _reduction,
        aten.grid_sampler_2d: _bilinear})
