"""Multi-process runtime: one process per card, joined in one ``torch.distributed``
process group (PyTorch port of sisr_tpu's ``parallel/distributed.py``).

Launcher contracts, read from every process's environment:

* sisr_tpu's: ``SISR_TPU_COORDINATOR`` (``host:port`` of rank 0's rendezvous, used as
  the ``tcp://`` store), ``SISR_TPU_NUM_PROCESSES`` (the world size) and
  ``SISR_TPU_PROCESS_ID`` (this rank), so a scheduler script written for sisr_tpu
  starts the port unchanged; with a missing partner variable it raises;
* torchrun's: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``.

``LOCAL_RANK`` picks the card (``cuda:<LOCAL_RANK>``); without it a rank takes card
``rank % visible cards``.  Without a launcher environment :func:`maybe_init_distributed`
is a no-op; repeated calls are idempotent.  An explicit world whose rendezvous or group
fails raises: it never goes on as N independent jobs that each believe they are
rank 0.

Backend rule: NCCL where every rank has a card of its own; gloo where the caller asks
for the CPU (``device='cpu'``), or where ranks share a card, since NCCL refuses two
ranks on one device ("Duplicate GPU detected").  The ranks publish which card each
holds (host name and card UUID) on the rendezvous store before the group is made, so
the rule is decided from that table, never by a backend that failed; rank 0 prints
the choice.  Every collective gives up after the group's timeout (300 s by default),
so a rank that dies cannot leave the others waiting for ever.
"""
import datetime
import os
import socket

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300
# the card of this process, fixed by maybe_init_distributed (None: LOCAL_RANK or 0)
_LOCAL_RANK = None


def _launch_environment():
    """(host, port, world size, rank) from a launcher's environment, or None."""
    env = os.environ
    if 'SISR_TPU_COORDINATOR' in env:
        missing = [v for v in ('SISR_TPU_NUM_PROCESSES', 'SISR_TPU_PROCESS_ID')
                   if v not in env]
        if missing:
            # defaulting to a 1-process world at rank 0 would bring every rank up as an
            # independent job that believes it is primary
            raise RuntimeError('SISR_TPU_COORDINATOR is set but %s %s missing — the '
                               'launcher must export all three.'
                               % (' and '.join(missing), 'is' if len(missing) == 1
                                  else 'are'))
        host, _, port = env['SISR_TPU_COORDINATOR'].rpartition(':')
        return (host, int(port), int(env['SISR_TPU_NUM_PROCESSES']),
                int(env['SISR_TPU_PROCESS_ID']))
    if 'RANK' in env and 'WORLD_SIZE' in env:
        missing = [v for v in ('MASTER_ADDR', 'MASTER_PORT') if v not in env]
        if missing:
            raise RuntimeError('RANK and WORLD_SIZE are set but %s missing — a torchrun '
                               'launch exports all four.' % ' and '.join(missing))
        return (env['MASTER_ADDR'], int(env['MASTER_PORT']), int(env['WORLD_SIZE']),
                int(env['RANK']))
    if env.get('SISR_TPU_MULTIHOST') == '1':
        raise RuntimeError('SISR_TPU_MULTIHOST=1 asks sisr_tpu to discover a TPU pod; '
                           'sisr_tpu_torch discovers nothing: export SISR_TPU_COORDINATOR, '
                           'SISR_TPU_NUM_PROCESSES and SISR_TPU_PROCESS_ID (or launch '
                           'with torchrun).')
    return None


def launcher_present():
    """Whether this process was started by a launcher (its environment names a world)."""
    return _launch_environment() is not None


def maybe_init_distributed(device=None, timeout=None):
    """Join the process group the launcher's environment describes; True once joined
    (also on a repeated call), False without a launcher environment.

    ``device='cpu'`` runs the rank on the CPU (gloo); otherwise each rank holds a card,
    and without CUDA this raises.  ``timeout`` (seconds, default
    :data:`DEFAULT_TIMEOUT_S`) bounds the rendezvous and every collective."""
    global _LOCAL_RANK
    if dist.is_initialized():
        return True
    launch = _launch_environment()
    if launch is None:
        return False
    host, port, world, rank = launch
    cpu = device is not None and torch.device(device).type == 'cpu'
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError('a %d-rank launch asks for CUDA (each rank on its card) but '
                           'torch.cuda.is_available() is False: ask for the CPU '
                           '(gpu = "off", --no-gpu) to run the ranks there.' % world)
    timeout = datetime.timedelta(seconds=timeout or DEFAULT_TIMEOUT_S)
    try:
        store = dist.TCPStore(host, port, world, is_master=rank == 0, timeout=timeout)
        if cpu:
            local, backend = int(os.environ.get('LOCAL_RANK', 0)), 'gloo'
        else:
            local = int(os.environ.get('LOCAL_RANK', rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
            props = torch.cuda.get_device_properties(local)
            store.set('sisr_tpu_torch/card/%d' % rank, '%s/%s' % (
                socket.gethostname(), getattr(props, 'uuid', local)))
            cards = [store.get('sisr_tpu_torch/card/%d' % r) for r in range(world)]
            backend = 'nccl' if len(set(cards)) == world else 'gloo'
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
    except (RuntimeError, ValueError, OSError) as exc:
        raise RuntimeError('process group init FAILED for an explicit %d-rank launch '
                           '(rank %d, rendezvous %s:%d): %s' % (world, rank, host, port,
                                                                exc)) from exc
    _LOCAL_RANK = local
    if rank == 0:
        print('sisr_tpu_torch: %d rank(s), backend %s (%s)' % (
            world, backend, 'CPU ranks' if cpu else 'a card per rank'
            if backend == 'nccl' else 'ranks share a card'))
    return True


def spawn_local_ranks(target, *args):
    """One rank per visible card, each a process that runs ``target(*args)`` under
    sisr_tpu's launcher contract with a localhost rendezvous (``LOCAL_RANK`` its card):
    what ``--gpu multi`` and ``--mesh`` start without a launcher.  A rank that fails
    fails the call (``torch.multiprocessing.spawn`` ends the others)."""
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        raise RuntimeError('data parallelism over the cards asks for CUDA, but '
                           'torch.cuda.is_available() is False: ask for the CPU '
                           '(gpu = "off", --no-gpu).')
    n = torch.cuda.device_count()
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    print('starting %d rank(s), one per card' % n)
    mp.spawn(_launched_rank, args=(n, port, target, args), nprocs=n)


def _launched_rank(index, world, port, target, args):
    os.environ.update({'SISR_TPU_COORDINATOR': 'localhost:%d' % port,
                       'SISR_TPU_NUM_PROCESSES': str(world),
                       'SISR_TPU_PROCESS_ID': str(index), 'LOCAL_RANK': str(index)})
    target(*args)


def rank():
    return dist.get_rank() if dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank():
    """This rank's card index (``LOCAL_RANK``, or the one chosen at init)."""
    if _LOCAL_RANK is not None:
        return _LOCAL_RANK
    return int(os.environ.get('LOCAL_RANK', 0))


def is_primary_host():
    """True on the process that owns filesystem writes (rank 0), and without a group.

    Every rank runs the same loop; checkpoints, CSV logs, plots and sample images are
    written once, by rank 0 — gate them on this."""
    return rank() == 0


def barrier():
    """Wait until every rank is here (no-op without a group)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == 'nccl':
        dist.barrier(device_ids=[local_rank()])
    else:
        dist.barrier()


def broadcast_object(obj, src=0):
    """Rank ``src``'s ``obj`` on every rank (picklable; no-op without a group): the
    decisions that end or branch a loop are made once and shared."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
