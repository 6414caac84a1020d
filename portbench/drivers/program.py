"""The program under test, built from a configuration: the only place
the drivers construct `usot_tpu_torch` objects."""
from __future__ import annotations

import torch


def model(config: dict, weights: dict, device, fused_xcorr=None):
    """`build_usot` at the configuration's widths and compute dtype on
    `device`, holding `weights`."""
    from usot_tpu_torch.models.usot import build_usot

    m = build_usot(mem_size=config["mem_size"], width=config["width"],
                   channels=config["channels"],
                   fused_xcorr=config.get("fused_xcorr", False)
                   if fused_xcorr is None else fused_xcorr,
                   dtype=getattr(torch, config["dtype"]))
    m.to(device)
    m.load_state_dict(weights)
    return m


def tracker_config(config: dict):
    """The program's `TrackerConfig` holding the configuration's tracker
    settings."""
    from usot_tpu_torch.tracker.config import TrackerConfig

    p = TrackerConfig()
    p.update(dict(config["tracker"]))
    return p


def k1_launches() -> int:
    from usot_tpu_torch.ops.xcorr_kernel import launch_counts

    return launch_counts()["K1"]
