"""Threaded, order-preserving batch loader, dataset concatenation and a device
prefetcher (PyTorch port of sisr_tpu's ``data/loader.py``).

The loader decodes the items of upcoming batches on a thread pool (PIL and zlib
release the GIL); with ``shuffle`` each epoch's order comes from a dedicated RNG seeded
once from the global ``random`` stream when the loader is built.  With one worker the
items load in the iterating thread, in order, so a seeded run draws its crops and
flips as sisr_tpu's does.  :func:`device_prefetch` keeps the next batches on their way
to the card while the current one computes: pinned host memory and a ``non_blocking``
copy on a side CUDA stream, in a background thread.  With ``device_collate`` (the fused
eval protocol) uniform uint8 image lists are not stacked on the host: each image is
copied up on its own and the batch stacked on the card.  ``ITEMS_LOADED`` counts the
items every loader of the process has loaded (decoded), so a caller can show that a
pass decoded nothing, and that a rank decoded only its slice of each batch
(``process_shard``).
"""
from collections import deque
import contextlib
from concurrent.futures import ThreadPoolExecutor
import queue as queue_mod
import random
import threading

import numpy as np
import torch

from ..tools import profiling

# items loaded by any DataLoader of the process (dataset.__getitem__ calls); counted
# under a lock, since loader threads finish batches concurrently
ITEMS_LOADED = 0
_ITEMS_LOADED_LOCK = threading.Lock()


class ConcatDataset:
    """Minimal torch-style dataset concatenation; every dataset must carry the same
    metadata layout and the same online-degradation mode."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative = np.cumsum([len(d) for d in self.datasets]).tolist()
        self.metadata_keys = self.datasets[0].metadata_keys
        key_sets = {tuple(d.metadata_keys or []) for d in self.datasets}
        if len(key_sets) > 1:
            raise RuntimeError(
                'Concatenated training sets carry different metadata layouts %s — '
                'batches straddling the sets would misalign or fail to stack. Give '
                'every set the same degradation_metadata/metadata configuration.'
                % sorted(key_sets))
        modes = {bool(getattr(d, 'device_degradations', False)) for d in self.datasets}
        if len(modes) > 1:
            raise RuntimeError('Cannot mix device-mode and host-mode online '
                               'degradation across concatenated training sets.')
        self.device_degradations = modes.pop()

    def __len__(self):
        return self.cumulative[-1]

    def __getitem__(self, idx):
        for d_idx, bound in enumerate(self.cumulative):
            if idx < bound:
                prev = 0 if d_idx == 0 else self.cumulative[d_idx - 1]
                return self.datasets[d_idx][idx - prev]
        raise IndexError(idx)


class CelebaSplitSampler:
    """The images whose ``selected_attribute`` is positive first, then the others,
    each part in a random order (ref: data_handler.py:531-573).  The attribute is the
    first metadata key containing its name; the test is the sign, so amplified
    (+/-2) attributes split as plain ones.  The orders come from a dedicated numpy
    ``RandomState`` seeded once from the global numpy stream, here (sisr_tpu's)."""

    def __init__(self, data_source, selected_attribute='gender', **kwargs):
        self.discriminatory_attribute = selected_attribute
        datasets = data_source.datasets if isinstance(data_source, ConcatDataset) \
            else [data_source]
        self.positive_indices, self.negative_indices = [], []
        offset = 0
        for dataset in datasets:
            positive, negative, length = self._index_with_attribute(dataset)
            self.positive_indices += [i + offset for i in positive]
            self.negative_indices += [i + offset for i in negative]
            offset += length
        self.length = offset
        self._rng = np.random.RandomState(np.random.randint(0, 2 ** 31))

    def _index_with_attribute(self, dataset):
        found = [self.discriminatory_attribute in key for key in dataset.metadata_keys]
        if not any(found) or dataset.metadata is None:
            raise RuntimeError('CelebaSplitSampler: no metadata key contains %r (keys: %s); '
                               'give the training set CelebA attributes that include it.'
                               % (self.discriminatory_attribute, dataset.metadata_keys))
        position = found.index(True)
        pertinent = [m[position] for m in dataset.metadata]
        positive = [i for i, m in enumerate(pertinent) if m > 0]
        negative = [i for i, m in enumerate(pertinent) if m <= 0]
        return positive, negative, len(dataset.metadata)

    def __iter__(self):
        pos = self._rng.choice(self.positive_indices, len(self.positive_indices),
                               replace=False).tolist()
        neg = self._rng.choice(self.negative_indices, len(self.negative_indices),
                               replace=False).tolist()
        return iter(pos + neg)

    def __len__(self):
        return self.length


def _collate(items, device_images=False):
    """Stack per-item dicts into batch arrays (``metadata`` to (N, M) float32);
    strings stay lists; the dataset's ``metadata_keys`` list passes through once (it
    is the same for every item, and as strings it is no tensor); differently sized
    images (eval sets at bs>1) stay lists of arrays.  Items of ``request_crops``
    carry (K, h, w, c) crop stacks: the crops join the batch axis, and every other
    entry repeats per crop.  ``device_images`` keeps uint8 lr and hr images as lists
    (:func:`device_prefetch` stacks uniform ones on the card)."""
    out = {}
    crops_per_item = None
    for key in ('lr', 'hr'):
        if np.ndim(items[0].get(key)) >= 4:
            crops_per_item = np.shape(items[0][key])[0]
            break
    for key in items[0]:
        vals = [item[key] for item in items]
        if key == 'metadata_keys':
            out[key] = vals[0]
            continue
        if isinstance(vals[0], str):
            out[key] = [v for v in vals for _ in range(crops_per_item or 1)]
            continue
        arrs = [np.asarray(v) for v in vals]
        if arrs[0].ndim >= 4:  # crop stacks: crops into the batch axis
            out[key] = np.concatenate(arrs, axis=0)
            continue
        if device_images and key in ('lr', 'hr') and arrs[0].dtype == np.uint8 \
                and arrs[0].ndim == 3:
            out[key] = arrs
            continue
        try:
            stacked = np.stack(arrs, axis=0)
        except ValueError:  # ragged
            out[key] = arrs
            continue
        if crops_per_item is not None and arrs[0].ndim >= 1:
            stacked = np.repeat(stacked, crops_per_item, axis=0)
        out[key] = stacked
    return out


_PREFETCH_BATCHES = 3  # batches whose items are decoding at once


class DataLoader:
    """Order-preserving threaded batch loader (ref: torch DataLoader's options)."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=8,
                 drop_last=False, sampler=None, process_shard=None):
        """``sampler``: an iterable of indices (:class:`CelebaSplitSampler`) giving each
        epoch's order in place of ``shuffle``.

        ``process_shard`` (rank, count): every rank builds the same global batch order
        (the shuffle RNG and the sampler's are seeded from the global streams, which
        every rank seeds alike), and loads only its contiguous slice
        ``[rank*B/count, (rank+1)*B/count)`` of each batch of B that divides by count,
        marked ``_shard_factor`` count; a batch that does not (a ragged tail) is loaded
        whole, as sisr_tpu's loader does.  Per-item crops and flips draw from each
        rank's own stream, so crop positions differ from one process's run."""
        self.dataset = dataset
        self.sampler = sampler
        # uint8 images stay lists, for device_prefetch to stack on the card (the
        # fused eval protocol sets it)
        self.device_collate = False
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers or 1)
        self.drop_last = drop_last
        # seeded from the global stream once, here: epoch orders do not depend on how
        # many global draws item loading made (sisr_tpu's _shuffle_rng)
        self._shuffle_rng = random.Random(random.getrandbits(64))
        self.process_shard = tuple(process_shard) if process_shard else None

    def __len__(self):
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def _batches(self):
        if self.sampler is not None:
            indices = list(iter(self.sampler))
        else:
            indices = list(range(len(self.dataset)))
        if self.shuffle and self.sampler is None:
            self._shuffle_rng.shuffle(indices)
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _process_batches(self):
        """(the indices this process loads, the shard factor) of each global batch."""
        batches = self._batches()
        if not self.process_shard:
            return [(b, 1) for b in batches]
        rank, count = self.process_shard
        out = []
        for b in batches:
            if count > 1 and len(b) % count == 0:
                per = len(b) // count
                out.append((b[rank * per:(rank + 1) * per], count))
            else:
                out.append((b, 1))
        return out

    def _finish(self, items, factor=1):
        global ITEMS_LOADED
        with _ITEMS_LOADED_LOCK:
            ITEMS_LOADED += len(items)
        out = _collate(items, device_images=self.device_collate)
        if factor > 1:
            out['_shard_factor'] = factor
        return out

    def __iter__(self):
        """Each batch (of this rank's slice, under ``process_shard``)."""
        batches = iter(self._process_batches())
        if self.num_workers == 1:
            for batch, factor in batches:
                with profiling.span('loader.batch'):
                    out = self._finish([self.dataset[i] for i in batch], factor)
                yield out
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(batch):  # per-ITEM futures: all workers decode in parallel
                return [pool.submit(self.dataset.__getitem__, i) for i in batch]

            pending = deque()
            for batch, factor in batches:
                pending.append((submit(batch), factor))
                if len(pending) >= _PREFETCH_BATCHES:
                    break
            while pending:
                futs, factor = pending.popleft()
                nxt = next(batches, None)
                if nxt is not None:
                    pending.append((submit(nxt[0]), nxt[1]))
                with profiling.span('loader.batch'):
                    out = self._finish([f.result() for f in futs], factor)
                yield out


_DEVICE_BATCHES_AHEAD = 2  # batches on their way to the device at once


def _uniform_images(v):
    """A list of uint8 arrays of one shape (a batch for the card to stack)."""
    return isinstance(v, list) and bool(v) and all(
        isinstance(a, np.ndarray) and a.dtype == np.uint8 and a.shape == v[0].shape
        for a in v)


def device_prefetch(iterator, device):
    """Yield the batches of ``iterator`` with their arrays as tensors on ``device``,
    copied up to two batches ahead in a background thread.

    On CUDA each array is copied into pinned host memory and sent with a
    ``non_blocking`` copy on a side stream; the consumer's stream waits on an event
    recorded after the copies, and each tensor is marked as used by that stream so
    the caching allocator does not hand its memory out early.  A list of uint8 images
    of one shape (``DataLoader.device_collate``) goes up image by image the same way
    and is stacked on the card, on the side stream; ragged lists pass as they are.
    On the CPU the arrays become tensors without a copy (a list is stacked).
    """
    device = torch.device(device)
    side = torch.cuda.Stream(device) if device.type == 'cuda' else None

    on_side = (lambda: torch.cuda.stream(side)) if side is not None \
        else contextlib.nullcontext

    def upload(arr):
        t = torch.from_numpy(arr)
        return t.pin_memory().to(device, non_blocking=True) if side is not None else t

    def put(batch):
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object and v.ndim >= 1:
                with on_side():
                    out[k] = upload(v)
            elif _uniform_images(v):
                with on_side():
                    out[k] = torch.stack([upload(a) for a in v])
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
                with profiling.span('loader.upload'):
                    item = put(b)
                _put(item)
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
