"""Host-side data pipeline: split, shuffle, batch, prefetch.

A copy of ``pl_bert_tpu/data/pipeline.py`` (``split_train_val``,
``DataPipeline``, ``build_dataloader``, ``prefetch``): the same splits,
epoch orders and batches for the same seed. :func:`to_device` is the
port's ``device_put``: the trainer calls it inside the prefetch thread,
so the host-to-device copy (from pinned memory, ``non_blocking``)
overlaps the previous step's device compute.

Reproduces the reference loader factory semantics
(reference: dataloader.py:225-274): 95/5 train/val split with the val
side capped at 10k samples, shuffled split indices, shuffled train
epochs with drop_last, sequential full-coverage validation.

Upgrades over the reference:
- deterministic per-epoch permutations keyed by (seed, epoch) → data
  order is resume-deterministic (the reference restarts from epoch 0,
  SURVEY §5 checkpoint note);
- fixed-shape batches;
- a background-thread prefetcher so host masking overlaps device steps.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from pl_bert_tpu_torch.data.collate import Batch, collate_fixed
from pl_bert_tpu_torch.data.dataset import MaskedPhonemeDataset


def split_train_val(
    total: int, seed: int = 1, val_fraction: float = 0.05, val_cap: int = 10_000
) -> tuple[np.ndarray, np.ndarray]:
    val_size = min(int(total * val_fraction), val_cap)
    perm = np.random.Generator(np.random.Philox(seed)).permutation(total)
    return perm[: total - val_size], perm[total - val_size :]


class DataPipeline:
    """Iterates fixed-shape batches over a MaskedPhonemeDataset subset."""

    def __init__(
        self,
        dataset: MaskedPhonemeDataset,
        indices: np.ndarray,
        batch_size: int,
        max_seq_length: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 1,
    ) -> None:
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.max_seq_length = max_seq_length
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return self.indices
        # counter word 1 is a SUBSYSTEM TAG: the masker draws from
        # [0, 0, epoch, index] with the same key (masking.py), and
        # [0, 0, 0, e] would be bitwise the stream that masks validation
        # sample e at epoch 0 — tagging keeps the shuffle and masking
        # counter spaces disjoint
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 1, 0, epoch])
        )
        return self.indices[rng.permutation(len(self.indices))]

    def batches(self, epoch: int = 0, start_batch: int = 0) -> Iterator[Batch]:
        """Yield batches for one epoch, resumable from ``start_batch``."""
        order = self.epoch_order(epoch)
        n = len(order)
        stop = n - (n % self.batch_size) if self.drop_last else n
        for lo in range(start_batch * self.batch_size, stop, self.batch_size):
            chunk = order[lo : lo + self.batch_size]
            samples = [self.dataset.get(int(i), epoch=epoch) for i in chunk]
            yield collate_fixed(samples, self.max_seq_length)

    def __iter__(self) -> Iterator[Batch]:
        return self.batches(epoch=0)


def build_dataloader(
    dataset,
    batch_size: int,
    dataset_config: dict | None = None,
    use_token_ids: bool = False,
    seed: int = 1,
    **_: object,
) -> tuple[DataPipeline, DataPipeline]:
    """Reference-compatible factory: returns (train, val) pipelines."""
    cfg = dict(dataset_config or {})
    max_seq_length = int(cfg.get("max_seq_length", 512))
    ds = MaskedPhonemeDataset(
        dataset, use_token_ids=use_token_ids, seed=seed, **cfg
    )
    train_idx, val_idx = split_train_val(len(ds), seed=seed)
    train = DataPipeline(
        ds, train_idx, batch_size, max_seq_length,
        shuffle=True, drop_last=True, seed=seed,
    )
    val = DataPipeline(
        ds, val_idx, batch_size, max_seq_length,
        shuffle=False, drop_last=False, seed=seed,
    )
    return train, val


def to_device(batch: dict, device) -> dict:
    """A dict of numpy arrays (or tensors) as tensors on ``device``. For a
    CUDA device the arrays are staged in pinned memory and copied
    ``non_blocking`` on the current stream, which orders the copy before
    the kernels that read it."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


_SENTINEL = object()


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Run ``iterator`` in a daemon thread, buffering ``size`` items.

    Shuts the worker down when the CONSUMER stops early too (the normal
    num_steps exit leaves this generator mid-epoch): without the stop
    flag + drain, the worker would block in ``q.put`` for the life of
    the process, pinning ``size+1`` batches already on the device per
    abandoned run."""
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list[BaseException] = []
    stop = threading.Event()

    def worker() -> None:
        try:
            for item in iterator:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # propagate into consumer
            err.append(e)
        finally:
            # same stop-aware put as the items: the sentinel must WAIT
            # for queue space on the normal path (a put_nowait skipped
            # on a full queue would leave the consumer blocked in
            # q.get() forever) but give up once the consumer left
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a worker waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        # unlike the JAX copy, wait for the worker: it runs torch code, and
        # a daemon thread still inside torch when the interpreter exits
        # aborts the process ("terminate called without an active
        # exception") after a run that had completed
        thread.join(timeout=30)
