"""Host-side input pipeline: threaded sample assembly. The port's copy of
`usot_tpu/data/loader.py`, which replaces torch DataLoader worker
processes (ref: scripts/train_usot.py:337-344) with a thread pool. The
dataset's pixel work (`data/cvops.py`, torch CPU ops) releases the GIL
op by op, yet on the H100's 8-core host 8 threads made no more samples
per second than 1 (`PERF.md`; ROADMAP's first training
`perf_opt` item). The batches reach the card through
`data/shards.device_prefetch`.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples])
    return out


def _one_thread():
    """A worker's torch ops on one thread each (the setting is the
    calling thread's own): `num_workers` threads of torch's full pool
    would oversubscribe the host's cores."""
    torch.set_num_threads(1)


class DataLoader:
    """Iterates batches of collated numpy dicts; drop_last semantics.

    A producer thread assembles batch after batch with `num_workers`
    threads, up to `prefetch` batches ahead of the consumer. Each item
    derives its own generator from its index (`USOTDataset`), so the
    batches are the same whatever `num_workers` is. An item that raises
    raises in the consumer."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.dataset) // self.batch_size

    @staticmethod
    def _put_or_stop(q: queue.Queue, item, stop: threading.Event) -> bool:
        """Bounded put that gives up when the consumer has left."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, q: queue.Queue, stop: threading.Event):
        end = None  # the sentinel, or the exception that ended the run
        try:
            with ThreadPoolExecutor(self.num_workers,
                                    initializer=_one_thread) as pool:
                for b in range(len(self)):
                    if stop.is_set():
                        return
                    idx = range(b * self.batch_size,
                                (b + 1) * self.batch_size)
                    samples = list(pool.map(self.dataset.__getitem__, idx))
                    if not self._put_or_stop(q, collate(samples), stop):
                        return
        except Exception as e:  # surfaced in the consumer's thread
            end = e
        finally:
            self._put_or_stop(q, end, stop)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop),
                             daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join()
