"""Logging / meter utilities: the port's own copy of
`usot_tpu/utils/meters.py` (ref: lib/utils/train_utils.py:12-71)."""
from __future__ import annotations

import logging
import math
import os
import time


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def create_logger(output_dir: str, model_name: str, phase: str):
    root_output_dir = output_dir
    os.makedirs(root_output_dir, exist_ok=True)
    final_output_dir = os.path.join(root_output_dir, model_name)
    os.makedirs(final_output_dir, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = f"{model_name}_{time_str}_{phase}.log"
    final_log_file = os.path.join(final_output_dir, log_file)

    logger = logging.getLogger(f"usot_tpu_torch.{phase}")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    fh = logging.FileHandler(final_log_file)
    fh.setFormatter(fmt)
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger, final_output_dir


def print_speed(i, i_time, n, logger):
    """Progress + ETA (ref: train_utils.py:62-71)."""
    average_time = i_time
    remaining_time = (n - i) * average_time
    remaining_day = math.floor(remaining_time / 86400)
    remaining_hour = math.floor(remaining_time / 3600
                                - remaining_day * 24)
    remaining_min = math.floor(remaining_time / 60 - remaining_day * 1440
                               - remaining_hour * 60)
    logger.info("Progress: %d / %d [%d%%], Speed: %.3f s/iter, ETA %d:%02d:%02d"
                % (i, n, i / n * 100, average_time, remaining_day,
                   remaining_hour, remaining_min))

