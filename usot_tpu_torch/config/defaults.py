"""Config system: global defaults + strict YAML override. The port's own
copy of `usot_tpu/config/defaults.py`; PyYAML is imported only by
`update_config`, when a file is read, and without it the file is read as
JSON (the GPU machine has no PyYAML).

Mirrors the reference's three-tier config (ref: lib/config/config_usot.py:13-122,
experiments/train/USOT.yaml, experiments/test/USOT.yaml) but with our own
EDict and validation. Train-time config lives under cfg.USOT.{TRAIN,DATASET};
test-time tracker hyper-parameters live in `TrackerConfig`
(see usot_tpu_torch/tracker/config.py).
"""
from __future__ import annotations

import json

from usot_tpu_torch.utils.edict import EDict


def default_config() -> EDict:
    cfg = EDict()

    # ------ General ------
    cfg.GPUS = "0"  # kept for CLI compat; unused
    cfg.WORKERS = 8
    cfg.PRINT_FREQ = 10
    cfg.OUTPUT_DIR = "var/log"
    cfg.CHECKPOINT_DIR = "var/snapshot"

    cfg.USOT = EDict()
    cfg.USOT.TRAIN = EDict()
    cfg.USOT.TEST = EDict()
    cfg.USOT.DATASET = EDict()
    for name in ("VID", "GOT10K", "LASOT", "YTVOS"):
        cfg.USOT.DATASET[name] = EDict()

    # ------ Augmentation (template / search / memory) ------
    d = cfg.USOT.DATASET
    d.SHIFT = 4
    d.SCALE = 0.05
    d.SHIFTs = 64
    d.SCALEs = 0.18
    d.SHIFTm = 64
    d.SCALEm = 0.18
    d.VIDEO_QUALITY = 0.40
    d.FAR_SAMPLE = 3

    for name in ("VID", "GOT10K", "LASOT", "YTVOS"):
        d[name].PATH = f"data/{name.lower()}_flow/crop511/"
        d[name].ANNOTATION = f"data/{name.lower()}_flow/train.json"
    d.VID.USE = 14000
    d.GOT10K.USE = 19000
    d.LASOT.USE = 13000
    d.YTVOS.USE = 4000

    # ------ Training ------
    t = cfg.USOT.TRAIN
    t.MODEL = "USOT"
    # Model scale (reference: 64/256). Reduced values give dev/test-scale
    # models (e.g. the committed parity fixture trains at 8/32).
    t.WIDTH = 64
    t.CHANNELS = 256
    t.RESUME = False
    t.START_EPOCH = 1
    t.END_EPOCH = 30
    t.TEMPLATE_SIZE = 127
    t.SEARCH_SIZE = 255
    t.MEMORY_NUM = 4
    t.STRIDE = 8
    t.BATCH = 12
    t.BATCH_STAGE_2 = 12
    t.PRETRAIN = "imagenet_pretrain.npz"
    t.MOMENTUM = 0.9
    t.WEIGHT_DECAY = 0.0001
    t.WHICH_USE = ["VID", "LASOT", "GOT10K", "YTVOS"]
    t.ISTRUE = True
    t.WARM_POLICY = "step"
    t.UNFIX_POLICY = "log"
    t.WARMUP = EDict(
        IFNOT=True,
        TYPE="step",
        EPOCH=5,
        KWARGS=EDict(start_lr=0.0025, end_lr=0.005, step=1),
    )
    t.LR = EDict(TYPE="log", KWARGS=EDict(start_lr=0.005, end_lr=0.00002))
    t.LAYERS_LR = 0.1
    t.BASE_LR = 0.005
    t.UNFIX_EPOCH = 10
    t.MEMORY_EPOCH = 6
    t.LAMBDA_1_NAIVE = 0.20
    t.LAMBDA_SHIFT_EPOCHS = [0, 7, 9]
    t.LAMBDA_1_LIST = [0.30, 0.275, 0.25]
    t.LAMBDA_TOTAL = 0.9
    t.CLS_RATIO_SHIFT_EPOCHS = [0, 7, 10]
    t.CLS_RATIOS = [0.6, 0.5, 0.4]
    t.TRAINABLE_LAYER = ["layer1", "layer2", "layer3"]

    # ------ Testing ------
    te = cfg.USOT.TEST
    te.MODEL = t.MODEL
    te.ISTRUE = True
    te.THREADS = 8
    te.DATA = "VOT2018"
    te.START_EPOCH = 10
    te.END_EPOCH = 30
    te.DATASET_ROOT = "datasets_test"
    te.RESULT_DIR = "var/result"
    te.ENGINE = "parity"
    te.MEM_SIZE = 4
    te.PROCESSES = 1

    # ------ Preprocessing (pseudo-label factory; cli.onekey stage) ------
    pre = cfg.USOT.PREPROCESS = EDict()
    pre.ISTRUE = False
    pre.DATA_DIR = ""
    pre.OUTPUT_DIR = ""
    pre.DATASET = "got10k"
    pre.INSTANCE_SIZE = 511
    pre.KEEP_ALL = False

    return cfg


def _update_dict(cfg: EDict, k, v, model_name: str) -> None:
    if k in ("TRAIN", "TEST", "PREPROCESS"):
        for vk, vv in v.items():
            cfg[model_name][k][vk] = vv
    elif k == "DATASET":
        for vk, vv in v.items():
            if vk not in ("VID", "GOT10K", "LASOT", "YTVOS"):
                cfg[model_name][k][vk] = vv
            else:
                for vvk, vvv in vv.items():
                    cfg[model_name][k][vk][vvk] = vvv
    else:
        cfg[k] = v


def update_config(cfg: EDict, config_file: str) -> EDict:
    """Merge a YAML experiment file into cfg, validating keys exist. On a
    machine without PyYAML the file is read as JSON (which is YAML, so
    either package reads a JSON config file the same)."""
    with open(config_file) as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        exp = json.loads(text)
    else:
        exp = yaml.safe_load(text)
    return update_config_dict(cfg, exp)


def update_config_dict(cfg: EDict, exp: dict) -> EDict:
    """Merge an experiment's contents ({"USOT": {...}}, as a YAML file
    holds them) into cfg, validating keys exist."""
    model_name = list(exp.keys())[0]
    if model_name not in ("USOT",):
        raise ValueError("unsupported model name %r in config" % model_name)
    for k, v in exp[model_name].items():
        if k in cfg or k in cfg[model_name]:
            _update_dict(cfg, k, v, model_name)
        else:
            raise ValueError(f"{k} does not exist in default config")
    return cfg


def load_config(config_file: str | None = None) -> EDict:
    cfg = default_config()
    if config_file:
        update_config(cfg, config_file)
    return cfg
