"""Training CLI, counterpart of `usot_tpu/cli/train.py` (ref:
scripts/train_usot.py).

    python -m usot_tpu_torch.cli.train --cfg experiments/train/USOT.yaml \
        [--shards <root>] [--workers N] [--dtype bfloat16] [--device cpu] \
        [--devices N] [--resume checkpoint_eN.pth|.ckpt]

Epoch loop with the reference schedule: naive Siamese until MEMORY_EPOCH,
cycle memory after; backbone layers 1-3 unfrozen at UNFIX_EPOCH (a new
optimizer: every group's momentum restarts, as JAX's `tx.init` does);
warmup + log LR decay; checkpoints from epoch 5. Runs on the GPU unless
`--device cpu` is given; without a GPU and without it, it raises.
`--resume` takes the port's `checkpoint_eN.pth` or `usot_tpu`'s
`checkpoint_eN.ckpt` (its weights, BN stats and optax momentum) and
continues at epoch N+1.

An epoch with a shard set under `--shards` (`<root>/epoch_XXX/`, written
by either package's `make_shards`) streams it; any other epoch, or every
epoch without `--shards`, trains from the live loader: `USOTDataset(cfg,
seed=epoch)` through the threaded `DataLoader` with `cfg.WORKERS`
threads (`--workers`), as JAX's trainer does. `--dtype bfloat16`
computes in bf16 over float32 parameters, BN statistics and optimizer
state.

Data parallel over `--devices N` ranks (default: every visible card; 1
under `--device cpu`), as JAX's trainer shards its global batch over a
1-D mesh: the global batch is BATCH x N (the LR unscaled), rank r holds
its rows of it (`parallel.mesh.rank_rows`), and the step is the
one-process step on the global batch (`train/step.py`). On the GPU the
N ranks are spawned processes, rank r on `cuda:r`, over NCCL; under
`--device cpu` they run on the CPU over gloo. Rank 0 alone logs and
writes checkpoints and `train_record.json`; every rank reads
`--resume`, and rank 0's parameters are broadcast after the load.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time

import torch
import torch.distributed as dist

from usot_tpu_torch.config.defaults import load_config
from usot_tpu_torch.core.device import f32_numerics, resolve_device
from usot_tpu_torch.data.dataset import USOTDataset
from usot_tpu_torch.data.loader import DataLoader
from usot_tpu_torch.data.shards import (ShardLoader, device_prefetch,
                                        epoch_dir, read_meta)
from usot_tpu_torch.models.convert import load_pretrain
from usot_tpu_torch.models.usot import build_usot, init_model
from usot_tpu_torch.parallel.mesh import (broadcast_module, file_rendezvous,
                                          is_main, launch, rank_rows,
                                          world_size)
from usot_tpu_torch.train.checkpoint import (peek_epoch, restore_checkpoint,
                                             save_model_epoch)
from usot_tpu_torch.train.optim import build_optimizer
from usot_tpu_torch.train.schedulers import build_lr_spaces
from usot_tpu_torch.train.step import epoch_weights, make_train_step
from usot_tpu_torch.utils.meters import (AverageMeter, create_logger,
                                         print_speed)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train USOT (PyTorch)")
    parser.add_argument("--cfg", default="experiments/train/USOT.yaml")
    parser.add_argument("--workers", type=int, default=None,
                        help="live-loader threads (cfg.WORKERS)")
    parser.add_argument("--devices", type=int, default=None,
                        help="data-parallel ranks (default: every visible "
                        "GPU; 1 with --device cpu): global batch BATCH x N")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU; raises "
                        "without one). `cpu` runs on the CPU")
    parser.add_argument("--shards", default=None,
                        help="shard-set root (cli.make_shards): epochs "
                        "with a <root>/epoch_XXX set stream it, the others "
                        "use the live loader")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype (parameters, BN statistics "
                        "and optimizer state stay float32)")
    parser.add_argument("--accum", type=int, default=1,
                        help="gradient-accumulation microbatches per "
                        "step: k-fold effective batch at 1/k activation "
                        "memory (the batch must divide by k)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the backbone's blocks in backward "
                        "(torch.utils.checkpoint): less activation memory "
                        "for one extra backbone forward")
    parser.add_argument("--resume", default=None,
                        help="checkpoint_eN.pth (the port's) or "
                        "checkpoint_eN.ckpt (usot_tpu's) to resume from "
                        "(continues at epoch N+1; overrides TRAIN.RESUME)")
    parser.add_argument("--stop-after-epoch", type=int, default=None,
                        help="stop cleanly after this epoch WITHOUT "
                        "altering the schedule (unlike lowering "
                        "END_EPOCH), so a later --resume continues the "
                        "same trajectory")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.cfg if os.path.exists(args.cfg) else None)
    if args.workers:
        cfg.WORKERS = args.workers
    return train(cfg, args)


def epoch_loader(cfg, args, epoch: int, cycle_memory: bool,
                 batch_size: int, reader=None, rows=None):
    """The epoch's batches: its shard set under `args.shards` where there
    is one, else the live loader over `USOTDataset(cfg, seed=epoch)`
    (`reader`, if given, replaces the dataset's frame reader). rows: a
    rank's rows of each global batch of `batch_size` (None: all).
    Returns (loader, a description for the log)."""
    if args.shards:
        sdir = epoch_dir(args.shards, epoch)
        smeta = read_meta(sdir)
        if smeta is not None:
            if smeta["cycle_memory"] != cycle_memory:
                raise ValueError(
                    f"shard set {sdir} was built for cycle_memory="
                    f"{smeta['cycle_memory']}, epoch {epoch} needs "
                    f"{cycle_memory}")
            return (ShardLoader(sdir, batch_size, rows=rows),
                    f"{smeta['n_samples']} samples from {sdir}")
    dataset = USOTDataset(cfg, seed=epoch, reader=reader)
    dataset.cycle_memory = cycle_memory
    return (DataLoader(dataset, batch_size, num_workers=cfg.WORKERS,
                       rows=rows),
            f"{len(dataset)} samples from the live loader, "
            f"{cfg.WORKERS} workers")


def rank_devices(n, device, devices=None):
    """The data-parallel ranks' devices: `devices` as given (n, if set,
    must match), else n ranks (default: every visible card; 1 on the
    CPU): on the CPU all on `device`, on the GPU rank r on `cuda:r`, or
    `device` itself for one rank. Raises when n exceeds the visible
    cards."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if n not in (None, len(devices)):
            raise ValueError(f"--devices {n} for {len(devices)} devices")
        return devices
    if n is not None and n < 1:
        raise ValueError(f"--devices {n}")
    if device.type != "cuda":
        return [device] * (n or 1)
    visible = torch.cuda.device_count()
    n = n or visible
    if n > visible:
        raise ValueError(f"--devices {n}: {visible} CUDA device(s) visible")
    return [device] if n == 1 else [torch.device("cuda", i)
                                    for i in range(n)]


def train(cfg, args, device=None, reader=None, backend=None, devices=None):
    """Run the schedule of `cfg.USOT.TRAIN` with the options of `args`
    (`parse_args`'s namespace) on `device` (default: `args.device`, else
    the GPU). `reader` replaces the live loader's frame reader (frames
    held in memory; with more than one rank it must pickle). Returns the
    per-epoch record also written to `OUTPUT_DIR/train_record.json`.

    Data parallel: one rank per entry of `rank_devices(args.devices,
    device, devices)`; `devices` (a list, which may repeat a card) and
    `backend` are arguments for callers that place ranks themselves,
    e.g. two gloo ranks on one card. backend: default NCCL when every
    rank has a card of its own, else gloo. One rank with no backend runs
    in this process without a process group; with a backend (NCCL at
    world size 1) it joins a group of one. The group meets at a
    `file://` rendezvous under OUTPUT_DIR."""
    device = resolve_device(device if device is not None else args.device)
    devices = rank_devices(args.devices, device, devices)
    if len(devices) == 1 and backend is None:
        return _train(cfg, args, devices[0], reader)
    if backend is None:
        distinct = len(set(devices)) == len(devices)
        backend = "nccl" if distinct and all(
            d.type == "cuda" for d in devices) else "gloo"
    launch(_train_rank, devices, backend, file_rendezvous(cfg.OUTPUT_DIR),
           args=(cfg, args, reader))
    with open(os.path.join(cfg.OUTPUT_DIR, "train_record.json")) as f:
        return json.load(f)


def _train_rank(rank, world, group, device, cfg, args, reader):
    _train(cfg, args, device, reader, group)


def _quiet_logger(rank: int):
    logger = logging.getLogger(f"usot_tpu_torch.train.rank{rank}")
    logger.propagate = False
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


def _train(cfg, args, device, reader, group=None):
    """The schedule in this process: alone (group None) or as one rank of
    `group`."""
    tc = cfg.USOT.TRAIN
    rank = 0 if group is None else dist.get_rank(group)
    world = world_size(group)
    main_rank = is_main()
    resume_path = args.resume or (
        tc.RESUME if isinstance(tc.RESUME, str) else None)
    if resume_path and not os.path.exists(resume_path):
        raise FileNotFoundError(f"--resume checkpoint {resume_path}")
    start_epoch = tc.START_EPOCH
    if resume_path:
        ckpt_epoch = peek_epoch(resume_path)
        start_epoch = ckpt_epoch + 1
    f32_numerics()

    writer = None
    if main_rank:
        logger, log_dir = create_logger(cfg.OUTPUT_DIR, "USOT", "train")
        logger.info("config: %s", cfg)
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
        except ImportError:  # optional, as in the JAX CLI
            pass
    else:
        logger = _quiet_logger(rank)

    model = build_usot(mem_size=tc.MEMORY_NUM, width=tc.WIDTH,
                       channels=tc.CHANNELS,
                       dtype=getattr(torch, args.dtype))
    init_model(model, torch.Generator().manual_seed(0), device=device)
    pretrain_path = os.path.join("pretrain", tc.PRETRAIN)
    if os.path.exists(pretrain_path):
        load_pretrain(model, pretrain_path)
        logger.info("loaded pretrain %s", pretrain_path)
    else:
        logger.warning("pretrain %s not found; training from scratch",
                       pretrain_path)
    logger.info("device: %s, compute dtype %s, %d rank(s)", device,
                args.dtype, world)

    lr_spaces = build_lr_spaces(tc, tc.END_EPOCH)

    def build(epoch):
        return build_optimizer(model, tc.MOMENTUM, tc.WEIGHT_DECAY,
                               tc.LAYERS_LR, epoch >= tc.UNFIX_EPOCH,
                               tuple(tc.TRAINABLE_LAYER))[0]

    if resume_path:
        # the groups differ across UNFIX_EPOCH: build the checkpoint's
        # stage before loading its momentum buffers
        optimizer = build(ckpt_epoch)
        restore_checkpoint(resume_path, model, optimizer)
        logger.info("resumed from %s at epoch %d", resume_path, start_epoch)
    else:
        optimizer = build(start_epoch)
    if group is not None:
        broadcast_module(model, group)

    # per-epoch record (losses, schedule state, timing), rewritten after
    # every epoch so a killed run leaves a usable partial record
    record = {"resumed_from": resume_path, "start_epoch": int(start_epoch),
              "end_epoch": int(tc.END_EPOCH), "device": str(device),
              "dtype": args.dtype, "world": world, "epochs": {}}
    record_path = os.path.join(cfg.OUTPUT_DIR, "train_record.json")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)

    global_step = 0
    for epoch in range(start_epoch, tc.END_EPOCH + 1):
        cycle_memory = epoch >= tc.MEMORY_EPOCH
        unfix = epoch >= tc.UNFIX_EPOCH
        if epoch == tc.UNFIX_EPOCH:
            logger.info("unfreezing backbone layers %s", tc.TRAINABLE_LAYER)
            optimizer = build(epoch)

        lambda_1, lambda_total, cls_ratio = epoch_weights(tc, epoch)
        step_fn = make_train_step(
            model, optimizer, cycle_memory=cycle_memory,
            stage_bn_train=unfix, lambda_1=lambda_1,
            lambda_total=lambda_total, lambda_1_naive=tc.LAMBDA_1_NAIVE,
            remat=args.remat, accum_steps=args.accum, group=group)

        batch_size = (tc.BATCH_STAGE_2 if cycle_memory else tc.BATCH) * world
        rows = None if group is None else rank_rows(batch_size, rank, world,
                                                    args.accum)
        loader, source = epoch_loader(cfg, args, epoch, cycle_memory,
                                      batch_size, reader, rows)
        lr = float(lr_spaces[epoch - 1])
        logger.info("epoch %d lr %.6f cycle_memory=%s batch=%d (%s)",
                    epoch, lr, cycle_memory, batch_size, source)

        batch_time = AverageMeter()
        losses = AverageMeter()
        iter_losses = []
        epoch_t0 = time.time()
        end = time.time()
        for it, batch in enumerate(device_prefetch(loader, device)):
            metrics = step_fn(batch, lr, cls_ratio)
            loss = float(metrics["loss"])
            iter_losses.append(round(loss, 6))
            losses.update(loss, batch_size)
            batch_time.update(time.time() - end)
            end = time.time()
            global_step += 1
            if writer is not None:
                writer.add_scalar("train_loss", loss, global_step)
            if (it + 1) % cfg.PRINT_FREQ == 0:
                logger.info(
                    "Epoch: [%d][%d/%d] lr: %.6f Batch Time: %.3fs "
                    "CLS_ORI: %.5f CLS_MEM: %.5f REG: %.5f Loss: %.5f "
                    "Skipped: %d",
                    epoch, it + 1, len(loader), lr, batch_time.avg,
                    float(metrics["cls_loss_ori"]),
                    float(metrics["cls_loss_memory"]),
                    float(metrics["reg_loss"]), losses.avg,
                    step_fn.skipped)
                print_speed(global_step, batch_time.avg,
                            tc.END_EPOCH * len(loader), logger)

        if main_rank:
            path = save_model_epoch(cfg.CHECKPOINT_DIR, model, optimizer,
                                    epoch)
            if path:
                logger.info("saved %s", path)

            record["epochs"][str(epoch)] = {
                "lr": lr, "cycle_memory": bool(cycle_memory),
                "unfix": bool(unfix),
                "lambda_1": float(lambda_1), "cls_ratio": float(cls_ratio),
                "batch": int(batch_size), "n_iters": len(iter_losses),
                "loss_avg": round(losses.avg, 6), "losses": iter_losses,
                "seconds": round(time.time() - epoch_t0, 3),
                "checkpoint": path,
            }
            with open(record_path, "w") as f:
                json.dump(record, f, indent=1)

        if args.stop_after_epoch is not None and \
                epoch >= args.stop_after_epoch:
            logger.info("stopping after epoch %d (--stop-after-epoch)",
                        epoch)
            break

    if writer is not None:
        writer.close()
    return record


if __name__ == "__main__":
    main()
