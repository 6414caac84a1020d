"""Offline pre-augmented training shards: the port's own copy of
`usot_tpu/data/shards.py` (the format is shared, so shard sets written by
`usot_tpu.cli.make_shards` feed the port's trainer), with
`device_prefetch` as pinned-memory, non-blocking copies to the GPU and
`epoch_dir` from `usot_tpu/cli/make_shards.py`.

The reference feeds its GPUs by brute force: 32 torch DataLoader worker
processes decoding + augmenting JPEGs per step (ref:
scripts/train_usot.py:337-344). Shards make the per-step host work ~zero
instead: the augmented epoch is computed ONCE to disk, then streamed.

Layout:
  * images are stored uint8 and CHANNEL-FLAT — (H, W*3) instead of
    (H, W, 3) — so a shard batch uploads 4x smaller than f32; the train
    step reshapes and converts to f32 on the device.
  * one uncompressed .npz per shard (zip member per field): np.load is
    lazy per key, reads are sequential, and JPEG-sourced pixels don't
    deflate enough to justify the CPU.

An epoch directory:
  <dir>/meta.json                 {n_samples, shard_size, cycle_memory,
                                   keys, seed}
  <dir>/shard_00000.npz ...       fields stacked along axis 0
"""
from __future__ import annotations

import collections
import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

_IMAGE_KEYS = ("template", "search", "search_memory")


def _pack_sample(sample: dict) -> dict:
    """Images -> channel-flat uint8; everything else -> float32."""
    out = {}
    for k, v in sample.items():
        v = np.asarray(v)
        if k in _IMAGE_KEYS:
            # (..., H, W, 3) float -> (..., H, W*3) uint8
            flat = v.reshape(v.shape[:-2] + (-1,))
            out[k] = np.clip(np.round(flat), 0, 255).astype(np.uint8)
        else:
            out[k] = v.astype(np.float32)
    return out


def write_shards(dataset, out_dir: str, n_samples: int | None = None,
                 shard_size: int = 256, workers: int = 4,
                 log_every: int = 0, logger=None) -> dict:
    """Materialize `n_samples` augmented samples from `dataset` into
    `out_dir`. Deterministic: USOTDataset derives per-item RNG from
    (seed, index), so a shard set is reproducible from (cfg, seed)."""
    os.makedirs(out_dir, exist_ok=True)
    n = n_samples or len(dataset)
    meta = {"n_samples": int(n), "shard_size": int(shard_size),
            "cycle_memory": bool(dataset.cycle_memory),
            "seed": int(getattr(dataset, "seed", 0)), "keys": None}

    written = 0
    shard_id = 0
    with ThreadPoolExecutor(max(1, workers)) as pool:
        while written < n:
            count = min(shard_size, n - written)
            samples = list(pool.map(
                dataset.__getitem__, range(written, written + count)))
            packed = [_pack_sample(s) for s in samples]
            arrays = {k: np.stack([p[k] for p in packed])
                      for k in packed[0]}
            if meta["keys"] is None:
                meta["keys"] = sorted(arrays)
            np.savez(os.path.join(out_dir, f"shard_{shard_id:05d}.npz"),
                     **arrays)
            written += count
            shard_id += 1
            if log_every and shard_id % log_every == 0:
                msg = f"shards: {written}/{n} samples ({shard_id} files)"
                (logger.info if logger else print)(msg)
    meta["n_shards"] = shard_id
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def epoch_dir(root: str, epoch: int) -> str:
    """An epoch's shard directory under a shard-set root."""
    return os.path.join(root, f"epoch_{epoch:03d}")


def read_meta(shard_dir: str) -> dict | None:
    path = os.path.join(shard_dir, "meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def device_prefetch(iterable, device):
    """Yield the batches of `iterable` (dicts of numpy arrays) as tensors
    on `device`, with the next two uploads in flight.

    On a GPU each array is copied into pinned host memory and sent with a
    `non_blocking` copy on a side stream, so batch i+1 travels while
    batch i trains; the consumer's stream waits for the copy before it
    uses the batch, and the caching allocator is told the tensors are
    used there. On the CPU the arrays are wrapped, not copied."""
    if device.type != "cuda":
        for batch in iterable:
            yield {k: torch.from_numpy(v) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(stream):
            dev = {k: torch.from_numpy(v).pin_memory().to(
                device, non_blocking=True) for k, v in batch.items()}
            return dev, stream.record_event()

    q: collections.deque = collections.deque()
    it = iter(iterable)
    for batch in it:
        q.append(put(batch))
        if len(q) == 2:
            break
    while q:
        batch, copied = q.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(copied)
        for t in batch.values():
            t.record_stream(current)
        nxt = next(it, None)
        if nxt is not None:
            q.append(put(nxt))
        yield batch


class ShardLoader:
    """Streams collated batches from a shard directory.

    Per-step host work is a slice + (for partial shard tails) a
    concatenate — no decode, no augmentation. A background thread reads
    the next shard from disk while the current one feeds the chip.

    rows: a data-parallel rank's rows of each global batch of
    `batch_size` (`parallel.mesh.rank_rows`), in that order; the rank
    keeps and uploads only those (the reader thread still loads whole
    shards: an npz member has no partial read). None: every row. Given
    rows need drop_last."""

    def __init__(self, shard_dir: str, batch_size: int,
                 drop_last: bool = True, prefetch: int = 2, rows=None):
        if rows is not None and not drop_last:
            raise ValueError("a rank's rows need whole global batches "
                             "(drop_last=True)")
        self.shard_dir = shard_dir
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.rows = np.arange(batch_size) if rows is None \
            else np.asarray(rows)
        self.meta = read_meta(shard_dir)
        if self.meta is None:
            raise FileNotFoundError(f"no meta.json in {shard_dir}")
        self.n_samples = self.meta["n_samples"]

    def __len__(self):
        if self.drop_last:
            return self.n_samples // self.batch_size
        return -(-self.n_samples // self.batch_size)

    def _shard_paths(self):
        return [os.path.join(self.shard_dir, f"shard_{i:05d}.npz")
                for i in range(self.meta["n_shards"])]

    @staticmethod
    def _put_or_stop(q: queue.Queue, item, stop: threading.Event) -> bool:
        """Bounded put that wakes up when the consumer abandons the
        iterator (stop set in __iter__'s finally). A plain q.put would
        block forever holding a decoded shard (~hundreds of MB)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _read_shards(self, q: queue.Queue, stop: threading.Event):
        # The None sentinel must reach the consumer even if a read
        # raises (corrupt shard) — otherwise __iter__ blocks forever.
        err = None
        try:
            for path in self._shard_paths():
                if stop.is_set():
                    return
                try:
                    with np.load(path) as z:
                        shard = {k: z[k] for k in z.files}
                except Exception as e:  # surface in the consumer thread
                    err = RuntimeError(f"failed reading shard {path}: {e}")
                    return
                if not self._put_or_stop(q, shard, stop):
                    return
        finally:
            self._put_or_stop(q, err, stop)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._read_shards, args=(q, stop),
                             daemon=True)
        t.start()
        tail: dict | None = None
        try:
            while True:
                shard = q.get()
                if shard is None:
                    break
                if isinstance(shard, Exception):
                    raise shard
                if tail is not None:
                    shard = {k: np.concatenate([tail[k], shard[k]])
                             for k in shard}
                    tail = None
                n = len(next(iter(shard.values())))
                full = n - n % self.batch_size
                for s in range(0, full, self.batch_size):
                    yield {k: v[s + self.rows] for k, v in shard.items()}
                if full < n:
                    tail = {k: v[full:] for k, v in shard.items()}
            if tail is not None and not self.drop_last:
                yield tail
        finally:
            stop.set()
