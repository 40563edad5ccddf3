"""Background checkpoint writer (the semantics of sisr_tpu's ``utils/async_ckpt.py``).

The epoch loop saves a checkpoint every epoch (ref: Code/SISR/models/__init__.py:349-380).
With ``async_checkpoint = true`` the save costs the loop only the copy of the state to
host tensors (:func:`to_host`, taken at the call, so the next step's in-place Adam
update cannot race the writer); the ``torch.save`` and the disk write run on one
background thread (:data:`WRITER`).

* One worker thread: writes land in submission order.
* A bounded queue: ``submit`` blocks while ``max_pending`` writes are in flight, each
  holding a host copy of the state.
* ``wait()`` is the fence; callers fence before reading or deleting checkpoint files
  (load, best/last resolution, the end of training).  A worker's exception is
  re-raised there (and on the next ``submit``), so a failed write cannot pass silently.
* The pool's thread is not a daemon, and ``concurrent.futures`` joins it at interpreter
  exit, so a CLI that saves and returns still flushes its queue.
* Files are written to a dot-prefixed ``.tmp-<pid>-<name>`` sibling, fsync'd, then
  renamed over the real name (and the directory fsync'd): a crash mid-write never leaves
  a truncated checkpoint under the real name.  A directory checkpoint
  (``utils/orbax_ckpt.py``) at that name is moved aside and removed, and the other way
  round.
* ``checkpoint_dtype = "bf16_moments"``: :func:`narrow_moments` casts Adam's
  ``exp_avg`` and ``exp_avg_sq`` to bfloat16 for the disk (half their bytes);
  ``Optimizer.load_state_dict`` casts them back to their parameters' type at load.
"""
import os
import shutil
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch


def to_host(tree):
    """A copy of ``tree`` (nested dicts, lists and tuples) with every tensor copied to
    a fresh host tensor; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to('cpu', copy=True)
    return tree


MOMENT_KEYS = ('exp_avg', 'exp_avg_sq')  # Adam's moments in its state_dict


def narrow_moments(optimizer_state, dtype=torch.bfloat16):
    """An optimizer state_dict with every moment tensor (:data:`MOMENT_KEYS`) cast to
    ``dtype`` (new tensors; the live state is untouched), the rest as it is."""
    state = {index: {k: v.to(dtype) if k in MOMENT_KEYS and torch.is_tensor(v) else v
                     for k, v in entry.items()}
             for index, entry in optimizer_state['state'].items()}
    return {**optimizer_state, 'state': state}


def remove_path(path):
    """Remove a file or a directory tree (nothing if neither is there)."""
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)


def replace_atomically(staging, path):
    """Move ``staging`` (a file or a directory) to ``path``.  A file over a file is one
    rename; otherwise what held ``path`` is renamed aside first and removed after, so
    ``path`` names the old checkpoint or the new one, whole, at every moment but the
    one between the two renames."""
    if not os.path.isdir(staging) and not os.path.isdir(path):
        os.replace(staging, path)
        return
    head, base = os.path.split(path)
    aside = os.path.join(head, '.old-%d-%s' % (os.getpid(), base))
    remove_path(aside)
    had_old = os.path.lexists(path)
    if had_old:
        os.rename(path, aside)
    os.rename(staging, path)
    if had_old:
        remove_path(aside)


def sweep_stale_tmp(head, base, max_age_s=3600):
    """Remove crash-leftover ``.tmp-<pid>-<base>`` and ``.old-<pid>-<base>`` siblings
    (files or directories) older than ``max_age_s`` (a killed writer leaves a
    full-size staging copy under a pid a restarted run never matches)."""
    suffix = '-%s' % base
    try:
        entries = os.listdir(head)
    except OSError:
        return
    for name in entries:
        if not (name.startswith(('.tmp-', '.old-')) and name.endswith(suffix)):
            continue
        full = os.path.join(head, name)
        try:
            if time.time() - os.stat(full).st_mtime >= max_age_s:
                remove_path(full)
        except OSError:
            pass  # gone already, or a live writer's


def atomic_save(obj, path):
    """``torch.save(obj)`` to ``path`` through an fsync'd dot-prefixed sibling and a
    rename (the sibling never matches the ``train_model_*`` names that best/last
    resolution scans); a directory checkpoint at ``path`` is replaced."""
    head, base = os.path.split(path)
    sweep_stale_tmp(head, base)
    tmp = os.path.join(head, '.tmp-%d-%s' % (os.getpid(), base))
    with open(tmp, 'wb') as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())  # the rename makes the name durable, not the data
    replace_atomically(tmp, path)
    try:  # make the rename itself durable
        dfd = os.open(head or '.', os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # a platform without directory fsync


class AsyncCheckpointWriter:
    """Single-threaded ordered background writer with fence-time error propagation."""

    def __init__(self, max_pending=2):
        self._pool = None
        self._lock = threading.Lock()
        self._pending = []   # (path, future), submission order
        self._failed = []    # every worker failure since the last fence
        self.max_pending = max_pending

    def submit(self, path, job):
        """Queue ``job()`` (the write of ``path``).  Raises any error a previously
        queued write produced; blocks while ``max_pending`` writes are in flight."""
        self._reap(raise_failed=True)
        while True:
            with self._lock:
                in_flight = [f for _, f in self._pending if not f.done()]
            if len(in_flight) < self.max_pending:
                break
            in_flight[0].exception()  # wait for the oldest write to drain
            self._reap(raise_failed=True)
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix='ckpt-writer')
            self._pending.append((path, self._pool.submit(job)))

    def _reap(self, raise_failed):
        with self._lock:
            done = [(p, f) for p, f in self._pending if f.done()]
            self._pending = [(p, f) for p, f in self._pending if not f.done()]
        for path, fut in done:
            err = fut.exception()
            if err is not None:
                self._failed.append((path, err))
        if raise_failed and self._failed:
            failures, self._failed = self._failed, []
            # the raise carries the first failure, the rest print: an operator must
            # learn that more than one epoch is missing
            for extra_path, extra_err in failures[1:]:
                print('WARNING: background checkpoint write of %r also failed: %r'
                      % (extra_path, extra_err), file=sys.stderr)
            path, err = failures[0]
            raise RuntimeError('background checkpoint write of %r failed' % path) from err

    def wait(self, timeout=None):
        """Block until every queued write is on disk; re-raise the first failure.
        ``timeout`` (seconds, across all pending writes) bounds the drain: on expiry a
        TimeoutError names the still-pending paths."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            pending = list(self._pending)
        for _, fut in pending:
            remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                fut.exception(timeout=remaining)  # waits; errors are handled in _reap
            except TimeoutError:
                self._reap(raise_failed=True)  # failures seen so far first
                raise TimeoutError('background checkpoint writes still pending after '
                                   '%.0fs: %s' % (timeout, self.pending_paths))
        self._reap(raise_failed=True)

    @property
    def pending_paths(self):
        with self._lock:
            return [path for path, _ in self._pending]


# process-global: checkpoints are often loaded through another handler object than the
# one that saved them (train, then eval, in one process), so the fence covers every
# pending write of the process
WRITER = AsyncCheckpointWriter()
