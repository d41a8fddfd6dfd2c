"""Async batched loader + device prefetch, port of
monodepth2_tpu/data/loader.py.

`DataLoader` and `accepts_rng` are copied (numpy batches, per-epoch shuffle,
worker-thread decode, bounded prefetch queue, `skip_next` for a mid-epoch
resume). `device_prefetch` is rebuilt for CUDA: each batch is pinned and
copied to the card with `non_blocking=True` on a side stream while the
current step runs (reference: the synchronous per-step transfer at
src/Monodepth.jl:157).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiler import count, span
from .dchain import resolves_item_K


def accepts_rng(dataset) -> bool:
    """True when `dataset.__getitem__` takes a second positional (rng) arg.

    Probed ONCE from the signature instead of `except TypeError` per item:
    a TypeError raised INSIDE a two-arg __getitem__ (a genuine dataset bug)
    must propagate, not be silently retried without the rng — the retry
    would yield unaugmented/differently-seeded items and corrupt the
    reproducibility contract the rng keying exists for."""
    import inspect

    try:
        sig = inspect.signature(dataset.__getitem__)
    except (TypeError, ValueError):
        return False  # builtins/extension types: assume classic 1-arg
    n_positional = 0
    for p in sig.parameters.values():
        if p.kind == p.VAR_POSITIONAL:
            return True
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n_positional += 1
    return n_positional >= 2  # (idx, rng) — self is already bound


class DataLoader:
    """Iterates (N, L, H, W, C) float32 numpy batches.

    shuffle reshuffles each epoch with a per-epoch fold of `seed`
    (reference: shuffleobs per epoch, src/Monodepth.jl:153).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 2,
        prefetch: int = 4,
        drop_last: bool = True,
        with_K: bool = False,
    ):
        if with_K:
            # fail fast at construction, not mid-epoch in a worker thread:
            # chains always expose K_of, so a hasattr check alone would pass
            # even when an underlying child has no calibration —
            # resolves_item_K asks supports_item_K first
            if not resolves_item_K(dataset):
                raise ValueError(
                    "with_K=True needs every item to resolve intrinsics: "
                    "the dataset (or some chained child) exposes neither "
                    "K_of(i) nor K"
                )
        self.with_K = with_K
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0
        # one-shot batch skip for mid-epoch resume (consumed by the next
        # __iter__): the shuffle order is a pure function of (seed, epoch), so
        # skipping the first k index-batches reproduces the exact data order a
        # crashed run would have seen
        self.skip_next = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 1000003 * self.epoch)
            rng.shuffle(order)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        skip, self.skip_next = self.skip_next, 0
        for start in range(skip * self.batch_size, stop, self.batch_size):
            yield order[start : start + self.batch_size]

    def __iter__(self) -> Iterator[np.ndarray]:
        self.epoch += 1
        epoch = self.epoch

        owns_rng = getattr(self.dataset, "owns_rng", False)
        takes_rng = not owns_rng and accepts_rng(self.dataset)
        # per-item intrinsics ride with the batch as {"frames", "K"} so each
        # item warps with its own calibration (DChain.K_of; the reference
        # trains a whole chain with one K, src/Monodepth.jl:99)
        K_of = None
        if self.with_K:
            K_of = getattr(self.dataset, "K_of", None) or (
                lambda i: self.dataset.K
            )

        def load_one(idx: int) -> np.ndarray:
            # per-item generator: thread-safe under the worker pool AND
            # reproducible independent of num_workers (a single shared
            # Generator is neither — numpy Generators are not thread-safe).
            # Datasets that derive their own rng declare owns_rng=True and
            # the loader skips constructing one.
            if owns_rng:
                return self.dataset[int(idx)]
            rng = np.random.default_rng([self.seed, epoch, int(idx)])
            if takes_rng:
                return self.dataset.__getitem__(int(idx), rng)
            return self.dataset[int(idx)]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop_evt = threading.Event()

        def put_or_stop(item) -> bool:
            # a plain q.put blocks forever once the consumer stops draining
            # (early `break` from fit(max_steps=...), exception in the train
            # loop) and the `finally: stop_evt.set()` can never unblock it —
            # leaking one daemon thread + a pinned batch per abandoned
            # iterator. Poll the event while waiting for queue space instead.
            while not stop_evt.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                try:
                    for idx_batch in self._index_batches():
                        if stop_evt.is_set():
                            return
                        with span("loader.batch"):
                            items = list(pool.map(load_one, idx_batch))
                            batch = np.stack(items, axis=0)
                            if K_of is not None:
                                Ks = np.stack(
                                    [
                                        np.asarray(K_of(int(i)), np.float32)
                                        for i in idx_batch
                                    ],
                                    axis=0,
                                )
                                batch = {"frames": batch, "K": Ks}
                        if not put_or_stop(batch):
                            return
                        count("loader.batches")
                    put_or_stop(None)
                except BaseException as e:  # surface worker errors to consumer
                    put_or_stop(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with span("loader.get"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop_evt.set()


def placement_prefetch(iterator, put, size: int = 2):
    """Keep `size` batches' placements in flight ahead of use: `put(batch)`
    of the next batch is called before the current one is yielded, so an
    asynchronous placement (device_prefetch's copy) overlaps the running
    step."""
    buf = collections.deque()
    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        nxt = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield nxt


def _map(fn, batch):
    """fn over the leaves of an array-or-{"frames","K"} batch."""
    if isinstance(batch, dict):
        return {k: fn(v) for k, v in batch.items()}
    return fn(batch)


def _leaves(batch) -> list:
    """The leaves of an array-or-{"frames","K"} batch."""
    return list(batch.values()) if isinstance(batch, dict) else [batch]


def device_prefetch(iterator, size: int = 2, device="cuda", dtype=np.float32):
    """Host batches (arrays, or {"frames","K"} dicts of them) as tensors on
    `device`, `size` batches ahead of use.

    On a card each leaf is pinned and copied with `non_blocking=True` on a
    side stream, so the copy of the next batches runs under the current step.
    The stream that takes a batch waits on its copy's event first, and each
    tensor is marked as used by that stream (`record_stream`), so that the
    allocator gives its memory to no later copy before the step has read it.
    On the CPU the leaves become tensors that share the arrays' memory: no
    copy, no thread."""
    device = resolve_device(device)
    as_array = lambda x: np.ascontiguousarray(x, dtype)
    if device.type != "cuda":
        for batch in iterator:
            yield _map(lambda x: torch.from_numpy(as_array(x)), batch)
        return
    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        with span("feed.pin"):
            pinned = _map(lambda x: torch.from_numpy(as_array(x)).pin_memory(), batch)
        count("feed.bytes_pinned", sum(t.nbytes for t in _leaves(pinned)))
        with torch.cuda.stream(copy_stream):
            out = _map(lambda t: t.to(device, non_blocking=True), pinned)
            return out, copy_stream.record_event()

    for out, copied in placement_prefetch(iterator, put, size=size):
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        _map(lambda t: t.record_stream(consumer), out)
        yield out
