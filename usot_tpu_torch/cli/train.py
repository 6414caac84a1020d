"""Training CLI, counterpart of `usot_tpu/cli/train.py` (ref:
scripts/train_usot.py).

    python -m usot_tpu_torch.cli.train --cfg experiments/train/USOT.yaml \
        [--shards <root>] [--workers N] [--dtype bfloat16] [--device cpu] \
        [--resume checkpoint_eN.pth|.ckpt]

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
state. One device.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from usot_tpu_torch.config.defaults import load_config
from usot_tpu_torch.core.device import resolve_device
from usot_tpu_torch.data.dataset import USOTDataset
from usot_tpu_torch.data.loader import DataLoader
from usot_tpu_torch.data.shards import (ShardLoader, device_prefetch,
                                        epoch_dir, read_meta)
from usot_tpu_torch.models.convert import load_pretrain
from usot_tpu_torch.models.usot import build_usot, init_model
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
                        help="number of GPUs; only 1 is supported")
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
                 batch_size: int, reader=None):
    """The epoch's batches: its shard set under `args.shards` where there
    is one, else the live loader over `USOTDataset(cfg, seed=epoch)`
    (`reader`, if given, replaces the dataset's frame reader). Returns
    (loader, a description for the log)."""
    if args.shards:
        sdir = epoch_dir(args.shards, epoch)
        smeta = read_meta(sdir)
        if smeta is not None:
            if smeta["cycle_memory"] != cycle_memory:
                raise ValueError(
                    f"shard set {sdir} was built for cycle_memory="
                    f"{smeta['cycle_memory']}, epoch {epoch} needs "
                    f"{cycle_memory}")
            return (ShardLoader(sdir, batch_size),
                    f"{smeta['n_samples']} samples from {sdir}")
    dataset = USOTDataset(cfg, seed=epoch, reader=reader)
    dataset.cycle_memory = cycle_memory
    return (DataLoader(dataset, batch_size, num_workers=cfg.WORKERS),
            f"{len(dataset)} samples from the live loader, "
            f"{cfg.WORKERS} workers")


def train(cfg, args, device=None, reader=None):
    """Run the schedule of `cfg.USOT.TRAIN` with the options of `args`
    (`parse_args`'s namespace) on `device` (default: `args.device`, else
    the GPU). `reader` replaces the live loader's frame reader (frames
    held in memory). Returns the per-epoch record also written to
    `OUTPUT_DIR/train_record.json`."""
    tc = cfg.USOT.TRAIN
    device = resolve_device(device if device is not None else args.device)
    resume_path = args.resume or (
        tc.RESUME if isinstance(tc.RESUME, str) else None)
    if resume_path and not os.path.exists(resume_path):
        raise FileNotFoundError(f"--resume checkpoint {resume_path}")
    start_epoch = tc.START_EPOCH
    if resume_path:
        ckpt_epoch = peek_epoch(resume_path)
        start_epoch = ckpt_epoch + 1
    if args.devices not in (None, 1):
        raise SystemExit(f"--devices {args.devices}: the port trains on one "
                         "GPU (no data parallel yet)")
    if device.type == "cuda":
        # parity with the f32 reference: cuDNN defaults to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    logger, log_dir = create_logger(cfg.OUTPUT_DIR, "USOT", "train")
    logger.info("config: %s", cfg)
    try:
        from tensorboardX import SummaryWriter
        writer = SummaryWriter(log_dir=os.path.join(log_dir, "tb"))
    except ImportError:  # optional, as in the JAX CLI
        writer = None

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
    logger.info("device: %s, compute dtype %s", device, args.dtype)

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

    # per-epoch record (losses, schedule state, timing), rewritten after
    # every epoch so a killed run leaves a usable partial record
    record = {"resumed_from": resume_path, "start_epoch": int(start_epoch),
              "end_epoch": int(tc.END_EPOCH), "device": str(device),
              "dtype": args.dtype, "epochs": {}}
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
            remat=args.remat, accum_steps=args.accum)

        batch_size = tc.BATCH_STAGE_2 if cycle_memory else tc.BATCH
        loader, source = epoch_loader(cfg, args, epoch, cycle_memory,
                                      batch_size, reader)
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
                    "CLS_ORI: %.5f CLS_MEM: %.5f REG: %.5f Loss: %.5f",
                    epoch, it + 1, len(loader), lr, batch_time.avg,
                    float(metrics["cls_loss_ori"]),
                    float(metrics["cls_loss_memory"]),
                    float(metrics["reg_loss"]), losses.avg)
                print_speed(global_step, batch_time.avg,
                            tc.END_EPOCH * len(loader), logger)

        path = save_model_epoch(cfg.CHECKPOINT_DIR, model, optimizer, epoch)
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
