"""Data parallelism over the ranks of a process group (PyTorch port of sisr_tpu's
``parallel/mesh.py``).

sisr_tpu replicates its state over a ``jax.sharding.Mesh`` and shards each batch on its
leading axis, and XLA inserts the collectives.  Here each card runs one process (see
:mod:`.distributed`), and :class:`MeshContext` is that process's view of the group:

* ``data`` parallelism: each rank takes its contiguous slice of every global batch
  (:meth:`MeshContext.shard_batch`); the train step's gradients are averaged by
  ``DistributedDataParallel`` (``BaseHandler.set_mesh``), and eval gathers its outputs
  in rank order (:meth:`MeshContext.gather`);
* the tile grid (the context-parallel analog): the tile batch padded to a multiple of
  the world size (:meth:`MeshContext.pad_batch_to_devices`), each rank's share run,
  the SR tiles gathered and stitched on every rank.

State is replicated from rank 0 (:meth:`MeshContext.replicate`).  Without a process
group a MeshContext is one rank: every method returns its input.
"""
import numpy as np
import torch
import torch.distributed as dist

from ..utils.helpers import resolve_device
from . import distributed


def make_mesh(n_devices=None, device=None):
    """The mesh of every rank of the process group (see :class:`MeshContext`)."""
    return MeshContext(n_devices=n_devices, device=device)


def make_multihost_mesh(devices_per_host=None, n_devices=None, device=None):
    """sisr_tpu's (hosts x local chips) mesh.  Here each rank holds card
    ``cuda:<LOCAL_RANK>`` on its host, and NCCL arranges its own hierarchy over the
    hosts (NVLink within one, the network between them), so no reshape of the ranks
    is needed: this is :func:`make_mesh`.  ``devices_per_host`` is accepted for
    sisr_tpu's signature; ``n_devices`` may not cut a multi-rank world."""
    if n_devices is not None and distributed.world_size() > 1 \
            and n_devices != distributed.world_size():
        raise ValueError('n_devices override is not valid on a multi-process launch — '
                         'the mesh must span every rank.')
    return MeshContext(device=device)


def _slice(v, axis, start, stop):
    return v[start:stop] if axis == 0 else v[:, start:stop]


def _is_batch_array(v, axis):
    if isinstance(v, torch.Tensor):
        return v.dim() > axis
    return isinstance(v, np.ndarray) and v.dtype != object and v.ndim > axis


class MeshContext:
    """This rank's view of the process group: its card, its slice of a batch, and the
    collectives that replicate state and gather results."""

    def __init__(self, n_devices=None, device=None):
        """``n_devices`` must be the world size (one process per card); ``device`` is
        ``cuda:<local rank>`` unless the caller passes ``'cpu'`` (gloo ranks on the
        CPU); without CUDA the default raises."""
        world = distributed.world_size()
        if n_devices is not None and int(n_devices) != world:
            raise ValueError('MeshContext(n_devices=%d): the port runs one process per '
                             'card, and this process group has %d rank(s) — launch %d '
                             'ranks (see sisr_tpu_torch.parallel.distributed).'
                             % (n_devices, world, n_devices))
        self.n_devices = world
        self.rank = distributed.rank()
        if device is not None and torch.device(device).type == 'cpu':
            self.device = torch.device('cpu')
        else:
            self.device = resolve_device(torch.device('cuda', distributed.local_rank()))
        # collectives only where a group exists (a 1-rank group included)
        self.group_up = dist.is_initialized()

    def shard_batch(self, batch, stacked_steps=False):
        """This rank's contiguous slice ``[r*B/W, (r+1)*B/W)`` of every array or
        tensor whose batch axis (axis 1 for ``stacked_steps``' (K, B, ...) layout)
        divides by the world size W; others (a ragged tail, lists, strings) stay whole,
        sisr_tpu's divisibility rule.  A batch that was cut carries ``_shard_factor``
        W, so the caller knows to gather what it computes from it."""
        w = self.n_devices
        if w == 1:
            return batch
        axis = 1 if stacked_steps else 0
        out, cut = dict(batch), False
        for k, v in batch.items():
            if k.startswith('_') or not _is_batch_array(v, axis) or v.shape[axis] % w:
                continue
            per = v.shape[axis] // w
            out[k] = _slice(v, axis, self.rank * per, (self.rank + 1) * per)
            cut = True
        if cut:
            out['_shard_factor'] = w
        return out

    def pad_batch_to_devices(self, batch, keys=('lr', 'hr', 'metadata')):
        """Pad the leading axis of ``keys`` up to a multiple of the world size with
        repeats of the last element (callers slice the outputs back)."""
        n = self.n_devices
        out = dict(batch)
        for k in keys:
            v = batch.get(k)
            if not _is_batch_array(v, 0):
                continue
            pad = (-v.shape[0]) % n
            if not pad:
                continue
            if isinstance(v, torch.Tensor):
                out[k] = torch.cat([v, v[-1:].expand(pad, *v.shape[1:])], dim=0)
            else:
                out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
        return out

    def gather(self, t, dim=0):
        """Every rank's ``t`` concatenated along ``dim`` in rank order (an
        ``all_gather``; every rank passes the same shape)."""
        if self.n_devices == 1:
            return t
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(self.n_devices)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=dim)

    def mean(self, t):
        """The mean of ``t`` over the ranks (an ``all_reduce``)."""
        if self.n_devices == 1:
            return t
        t = t.detach().clone()
        dist.all_reduce(t)
        return t / self.n_devices

    def replicate(self, module):
        """Rank 0's parameters and buffers copied into ``module`` on every rank (one
        broadcast per dtype of a flat copy)."""
        if not self.group_up or self.n_devices == 1:
            return module
        tensors = list(module.parameters()) + list(module.buffers())
        with torch.no_grad():
            for dtype in sorted({t.dtype for t in tensors}, key=str):
                group = [t for t in tensors if t.dtype == dtype]
                flat = torch.cat([t.detach().reshape(-1) for t in group])
                dist.broadcast(flat, src=0)
                offset = 0
                for t in group:
                    t.copy_(flat[offset:offset + t.numel()].view(t.shape))
                    offset += t.numel()
        return module
