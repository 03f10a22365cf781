"""Host-to-device streaming of minibatches.

Counterpart of ``ldagibbssampling_tpu/data/stream.py``.  The SVI backend
streams bag-of-words batches from host memory; the overlap worth having is
the host's slicing and the copy of batch ``t+1`` hidden behind the device's
work on batch ``t``.

:func:`prefetch_to_device` keeps ``depth`` copies in flight.  On a CUDA
device each batch is copied from pinned host memory (``pin_memory()``) with
``non_blocking=True`` on a side ``torch.cuda.Stream``; the consumer's
stream waits on the copy's event before the batch is handed over, and
``record_stream`` keeps the allocator from reusing the batch's memory while
the consumer's stream may still read it.  On ``device="cpu"`` the batches
pass through as tensors.  A ``cuda`` request without CUDA raises.

:func:`minibatch_indices` and :class:`BowStream` are numpy, copied from the
reference line for line, so one seed gives the same minibatches in both
packages.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch


def _tree_map(fn: Callable, batch: Any) -> Any:
    """``fn`` over the arrays of a batch: an array, or a tuple, list or dict
    of them (nested)."""
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


def prefetch_to_device(
    batches: Iterable,
    depth: int = 2,
    device: Any = "cuda",
) -> Iterator:
    """Yield ``device`` copies of ``batches`` in order, ``depth`` ahead of use.

    Each batch may be an array or tensor, or a tuple, list or dict of them.
    """
    from ldagibbssampling_tpu_torch.models.lda import resolve_device

    if depth < 1:
        raise ValueError("depth must be >= 1")
    dev = resolve_device(device)
    if dev.type == "cpu":
        for batch in batches:
            yield _tree_map(torch.as_tensor, batch)
        return

    copy_stream = torch.cuda.Stream(dev)
    queue: collections.deque = collections.deque()
    it = iter(batches)

    def put(batch):
        def copy(x):
            host = torch.as_tensor(x).pin_memory()
            with torch.cuda.stream(copy_stream):
                return host.to(dev, non_blocking=True)

        out = _tree_map(copy, batch)
        done = torch.cuda.Event()
        done.record(copy_stream)
        return out, done

    def take(entry):
        out, done = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)

        def hand_over(t):
            t.record_stream(consumer)
            return t

        return _tree_map(hand_over, out)

    for batch in it:
        queue.append(put(batch))
        if len(queue) >= depth:
            break
    while queue:
        entry = queue.popleft()
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(nxt))
        yield take(entry)


def minibatch_indices(
    num_items: int,
    batch_size: int,
    rng: np.random.Generator,
    drop_remainder: bool = False,
) -> Iterator[tuple[np.ndarray, int]]:
    """Shuffled index batches; the final partial batch is PADDED to full size
    (by repeating its own indices) unless dropped, so every batch has one
    shape.

    Yields ``(indices[batch_size], real_count)`` pairs.
    """
    order = rng.permutation(num_items)
    for s in range(0, num_items, batch_size):
        chunk = order[s : s + batch_size]
        real = len(chunk)
        if real < batch_size:
            if drop_remainder:
                return
            pad = np.resize(chunk, batch_size)
            yield pad, real
        else:
            yield chunk, real


class BowStream:
    """Bag-of-words minibatch source over a dense ``[M, V]`` array.

    Produces ``(indices, bow [B, V], real_count)`` with deterministic
    shuffling; plugs into :func:`prefetch_to_device`.
    """

    def __init__(self, bow: np.ndarray, batch_size: int, seed: int = 0):
        self.bow = bow
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def epoch(self) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
        for idx, real in minibatch_indices(
            self.bow.shape[0], self.batch_size, self._rng
        ):
            yield idx, self.bow[idx], real
