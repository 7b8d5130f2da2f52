"""Host-side data pipeline: batching, seeded pair sampling and a
background prefetch to the device.

Port of pulpo_tpu/data/loader.py. Datasets expose `__len__` and
`get_pair(index, rng)`, which returns a dict of channels-last numpy
arrays (the 8-entry schema: x, y, seg_x, seg_y, lm_x, lm_y, mask_x,
mask_y; an absent modality is None). Pair sampling threads an explicit
numpy Generator seeded by (seed, epoch) (DIVERGENCES.md 6), so the port
and the JAX package yield the same batches in the same order.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

BATCH_KEYS = ("x", "y", "seg_x", "seg_y", "lm_x", "lm_y", "mask_x", "mask_y")


def _collate(items: list[dict[str, Any]]) -> dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        if vals[0] is None:
            continue
        out[k] = np.stack(vals, axis=0)
    return out


class DataLoader:
    """Iterates a dataset in batches of numpy arrays; one epoch per
    __iter__ call."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self._epoch))
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        self._epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            items = [self.dataset.get_pair(int(i), rng) for i in idx]
            yield _collate(items)


def prefetch_to_device(iterator, device, size: int = 2):
    """Read batches ahead on a background thread and stage them on
    `device` as float32/int tensors, so that the step does not wait on
    the reader or the host-to-device copy.

    On the card the producer copies from pinned host memory on a stream
    of its own and records an event after the copy; the consumer makes
    its current stream wait on that event before it hands the batch
    out, so a step never reads a batch whose copy is still in flight.
    An exception raised by the reader is re-raised in the consumer."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()
    on_card = device.type == "cuda"

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            stream = torch.cuda.Stream(device) if on_card else None
            for batch in iterator:
                if stop.is_set():
                    return
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                event = None
                if on_card:
                    with torch.cuda.stream(stream):
                        staged = {k: v.pin_memory().to(device, non_blocking=True)
                                  for k, v in host.items()}
                        event = torch.cuda.Event()
                        event.record(stream)
                else:
                    staged = {k: v.to(device) for k, v in host.items()}
                if not put((staged, event)):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises
            put(("error", e))
            return
        put(done)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if item[0] == "error":
                raise item[1]
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for v in batch.values():
                    v.record_stream(current)
            yield batch
    finally:
        stop.set()
        t.join(timeout=10)
