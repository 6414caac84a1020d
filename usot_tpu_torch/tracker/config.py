"""Test-time tracker hyper-parameters (ref: lib/tracker/usot_tracker.py:366-394
defaults + experiments/test/USOT.yaml override). The port's own copy of
`usot_tpu/tracker/config.py`."""
from __future__ import annotations

from dataclasses import dataclass, field

# A target under this share of the image gets the big search area
# (ref: lib/tracker/usot_tracker.py:44-49).
SMALL_TARGET_SHARE = 0.004


@dataclass
class TrackerConfig:
    penalty_k: float = 0.021
    window_influence: float = 0.321
    lr: float = 0.730
    windowing: str = "cosine"
    exemplar_size: int = 127
    instance_size: int = 255
    total_stride: int = 8
    context_amount: float = 0.5
    # Feature size of template patch
    tf_size: int = 15
    # Feature axis of search area (== response size in USOT v1)
    sf_size: int = 25
    # Weight of the offline module in the response blend ((1-w) in paper)
    ratio: float = 0.3
    # Memory queue length N_q
    mem_queue_size: int = 7
    # Big/small search sizes picked per video at init
    small_sz: int = 255
    big_sz: int = 271
    score_size: int = field(init=False, default=25)

    def __post_init__(self):
        self.renew()

    def update(self, newparam: dict | None = None):
        if newparam:
            for k, v in newparam.items():
                setattr(self, k, v)
            self.renew()

    def renew(self):
        self.score_size = (
            (self.instance_size - self.exemplar_size) // self.total_stride
            + 1 + 8
        )

    def instance_of(self, target_sz, im_h, im_w) -> int:
        """The search size an init on a (w, h) target in an im_h x im_w
        image picks: big_sz for a small target, else small_sz."""
        share = (target_sz[0] * target_sz[1]) / float(im_h * im_w)
        return self.big_sz if share < SMALL_TARGET_SHARE else self.small_sz


def load_test_yaml(path: str) -> dict:
    import yaml  # only here: PyYAML is optional for the port

    with open(path) as f:
        obj = yaml.safe_load(f.read())
    return obj["TEST"] if "TEST" in obj else obj
