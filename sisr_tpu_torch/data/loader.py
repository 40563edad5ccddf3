"""Threaded, order-preserving batch loader and a device prefetcher (PyTorch port of the
eval subset of sisr_tpu's ``data/loader.py``).

The loader decodes the items of upcoming batches on a thread pool (PIL and zlib
release the GIL).  :func:`device_prefetch` keeps the next batches on their way to the
card while the current one computes: pinned host memory and a ``non_blocking`` copy
on a side CUDA stream, in a background thread.
"""
from collections import deque
from concurrent.futures import ThreadPoolExecutor
import queue as queue_mod
import threading

import numpy as np
import torch


def _collate(items):
    """Stack per-item dicts into batch arrays; strings stay lists; differently sized
    images (eval sets at bs>1) stay lists of arrays."""
    out = {}
    for key in items[0]:
        vals = [item[key] for item in items]
        if isinstance(vals[0], str):
            out[key] = vals
            continue
        arrs = [np.asarray(v) for v in vals]
        try:
            out[key] = np.stack(arrs, axis=0)
        except ValueError:  # ragged
            out[key] = arrs
    return out


_WORKERS = 8  # decode threads
_PREFETCH_BATCHES = 3  # batches whose items are decoding at once
_DEVICE_BATCHES_AHEAD = 2  # batches on their way to the device at once


class DataLoader:
    """Order-preserving threaded batch loader."""

    def __init__(self, dataset, batch_size=1):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _batches(self):
        n = len(self.dataset)
        return [list(range(i, min(i + self.batch_size, n)))
                for i in range(0, n, self.batch_size)]

    def __iter__(self):
        batches = iter(self._batches())
        with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
            def submit(batch):  # per-ITEM futures: all workers decode in parallel
                return [pool.submit(self.dataset.__getitem__, i) for i in batch]

            pending = deque()
            for batch in batches:
                pending.append(submit(batch))
                if len(pending) >= _PREFETCH_BATCHES:
                    break
            while pending:
                futs = pending.popleft()
                nxt = next(batches, None)
                if nxt is not None:
                    pending.append(submit(nxt))
                yield _collate([f.result() for f in futs])


def device_prefetch(iterator, device):
    """Yield the batches of ``iterator`` with their arrays as tensors on ``device``,
    copied up to two batches ahead in a background thread.

    On CUDA each array is copied into pinned host memory and sent with a
    ``non_blocking`` copy on a side stream; the consumer's stream waits on an event
    recorded after the copies, and each tensor is marked as used by that stream so
    the caching allocator does not hand its memory out early.  On the CPU the arrays
    become tensors without a copy.
    """
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == 'cuda' else None

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object and v.ndim >= 1:
                t = torch.from_numpy(v)
                if side is not None:
                    with torch.cuda.stream(side):
                        t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
            else:
                out[k] = v
        event = None
        if side is not None:
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    q = queue_mod.Queue(maxsize=_DEVICE_BATCHES_AHEAD)
    end = object()
    abandoned = threading.Event()  # the consumer dropped the generator early

    def _put(item):
        # bounded put that gives up once the consumer is gone, so an abandoned
        # generator never leaves this thread blocked holding device batches
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue_mod.Full:
                continue

    def uploader():
        try:
            for b in iterator:
                _put(put(b))
                if abandoned.is_set():
                    return
            _put(end)
        except BaseException as exc:  # re-raised on the consumer thread below
            _put(exc)

    thread = threading.Thread(target=uploader, daemon=True, name='sisr-device-prefetch')
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(stream)
            yield batch
    finally:
        abandoned.set()
        while not q.empty():  # release any staged device batches
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        thread.join(timeout=5)
