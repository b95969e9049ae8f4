"""Host data pipeline: collation, bucketed padding, prefetching loader.

Port of ``cryovit_tpu/data/pipeline.py`` (the reference's torch
``DataLoader`` + ragged ``collate_fn``, ``datamodules/utils.py:13-121``):

- **bucketing**: every batch is padded up to quantized bucket shapes. Labels
  pad with −1 (the masked loss ignores them), data pads with 0. The JAX
  package buckets to bound its recompiles; the port keeps the same shapes
  so both packages train on the same batches.
- **threaded prefetch**: ``num_workers`` decode threads read tomograms
  concurrently, an ordered coordinator collates and feeds a bounded queue,
  so host I/O overlaps the device step.

The reference's collate writes its label padding into ``data``
(``datamodules/utils.py:83-85``, silent at batch size 1); this one pads the
labels, as the JAX package does.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Sequence

import numpy as np

from cryovit_tpu_torch.types import TomogramBatch, TomogramData, pad_to, round_up

__all__ = ["collate", "BucketSpec", "DataLoader"]


@dataclass(frozen=True)
class BucketSpec:
    """Bucket quantization: pad depth/H/W up to these multiples."""

    depth: int = 32
    space: int = 32  # applies to the *data* spatial dims
    label_space: int = 32  # applies to the label spatial dims

    @staticmethod
    def for_input(input_key: str) -> "BucketSpec":
        if input_key == "dino_features":
            # feature grid quantum 4 → label quantum 64 voxels (4 × 16)
            return BucketSpec(depth=32, space=4, label_space=64)
        return BucketSpec(depth=32, space=64, label_space=64)


def collate(
    items: Sequence[TomogramData], bucket: BucketSpec | None = None
) -> tuple[TomogramBatch, list[TomogramData]]:
    """Pad a list of tomograms to a common bucket shape and stack.

    Returns the batch plus the original host records (for writers
    that need names/raw volumes). Data pads with 0; labels pad with −1.
    """
    bucket = bucket or BucketSpec()
    depths = [it.data.shape[0] for it in items]
    dmax = round_up(max(depths), bucket.depth)
    hmax = round_up(max(it.data.shape[1] for it in items), bucket.space)
    wmax = round_up(max(it.data.shape[2] for it in items), bucket.space)
    lh = round_up(max(it.label.shape[1] for it in items), bucket.label_space)
    lw = round_up(max(it.label.shape[2] for it in items), bucket.label_space)
    channels = items[0].data.shape[-1]

    data = np.stack(
        [pad_to(it.data, (dmax, hmax, wmax, channels), value=0.0) for it in items]
    )
    label = np.stack(
        [
            pad_to(it.label.astype(np.int8), (dmax, lh, lw), value=-1)
            for it in items
        ]
    )
    batch = TomogramBatch(
        data=data,
        label=label,
        num_slices=np.asarray(depths, dtype=np.int32),
    )
    return batch, list(items)


class DataLoader:
    """Minimal prefetching loader over an indexable dataset.

    Config-compatible with the reference dataloader node
    (``configs/datamodule/dataloader/default.yaml``): ``num_workers``,
    ``prefetch_factor``, ``batch_size``. ``shuffle`` reshuffles per epoch
    from a deterministic per-epoch seed (call :meth:`set_epoch`).
    """

    def __init__(
        self,
        dataset,
        batch_size: int | None = 1,
        shuffle: bool = False,
        num_workers: int = 8,
        prefetch_factor: int | None = 1,
        collate_fn: Callable | None = None,
        seed: int = 42,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size or 1
        self.shuffle = shuffle
        self.num_workers = max(0, int(num_workers))
        self.prefetch = max(1, int(prefetch_factor or 1))
        self.collate_fn = collate_fn or collate
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator:
        order = self._order()
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if self.num_workers == 0:
            for idxs in batches:
                yield self.collate_fn([self.dataset[int(i)] for i in idxs])
            return

        # Parallel decode pool + ordered assembly: `num_workers` threads
        # decode items concurrently (h5py/zlib release the GIL in the
        # native layer, so threads give real gzip-HDF5 parallelism, as the
        # reference's 8 DataLoader worker processes do); a coordinator keeps
        # a bounded window of batches in flight, reassembles them in order,
        # collates, and feeds a bounded queue.
        import concurrent.futures as cf
        from collections import deque

        out: queue.Queue = queue.Queue(maxsize=self.prefetch * self.num_workers)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put with stop polling: if the consumer abandons the
            # iterator, the producer must exit instead of blocking forever
            # on a full queue (thread + queued-batch leak)
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            pool = cf.ThreadPoolExecutor(
                max_workers=self.num_workers, thread_name_prefix="cryovit-decode"
            )
            try:
                pending = iter(batches)
                inflight: deque = deque()
                # enough batches in flight to keep every worker busy even
                # at batch_size=1 (the reference default)
                max_inflight = self.num_workers * self.prefetch + self.num_workers

                def refill() -> None:
                    while len(inflight) < max_inflight:
                        try:
                            idxs = next(pending)
                        except StopIteration:
                            return
                        inflight.append(
                            [
                                pool.submit(self.dataset.__getitem__, int(i))
                                for i in idxs
                            ]
                        )

                refill()
                while inflight and not stop.is_set():
                    futures = inflight.popleft()
                    refill()  # keep workers fed while we wait on the head
                    items = [f.result() for f in futures]
                    if not _put(self.collate_fn(items)):
                        return
                _put(None)
            except BaseException as e:  # propagate into the consumer
                _put(e)
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
