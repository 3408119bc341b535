"""Start the ranks of a sharded run as processes of one machine.

The reference runs one program over P devices; the port runs one process
a rank (torch.distributed). `spawn(fn, n_ranks, backend, devices)` starts
P processes (torch.multiprocessing, start method 'spawn'), joins them into
a process group through a `file://` rendezvous in a temporary directory
(a TCP port would clash between test workers running at once) and calls
fn(group, *args) in each, with `group` the rank's sharding.RankGroup.

The backend and each rank's device are arguments, never guessed:
- 'gloo' with every rank on 'cpu' (the tests);
- 'gloo' with every rank on 'cuda:0' where there is one card (gloo moves
  CUDA tensors through the host for all_gather and all_reduce);
- 'nccl' with one card a rank where there are P cards. NCCL refuses two
  ranks on one card; that error is raised, not worked around.

The kernels are built once in the parent before the ranks start (the
build directory is shared, and P ranks building into it at first use
would race). A command-line run under torchrun joins its group in
main/program.py instead.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import threading

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .sharding import RankGroup


def build_kernels():
    """Compile every CUDA source of the port (in parallel, one nvcc each);
    a build another process made from the same source is reused."""
    from ..ops._build import SOURCES, build_kernel
    errors = []

    def one(name):
        try:
            build_kernel(name)
        except Exception as e:        # raised below, in the caller
            errors.append(e)
    threads = [threading.Thread(target=one, args=(n,)) for n in SOURCES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _rank_main(rank, fn, n_ranks, backend, devices, init_file, args,
               out_dir, timeout_s):
    # one intra-op thread a rank: the ranks share the machine's cores
    torch.set_num_threads(1)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n_ranks,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        group = RankGroup(dist.group.WORLD, rank, n_ranks, device)
        torch.save(fn(group, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks, backend, devices, init_file=None, args=(),
          timeout_s=600):
    """Run fn(group, *args) on `n_ranks` ranks, rank r on devices[r], joined
    by `backend`; returns the list of the ranks' return values (which must
    pickle: numbers, numpy arrays, CPU tensors). `fn` must be importable
    by name (a module-level function). `init_file`, a path that does not
    exist yet, is the rendezvous; by default one in a temporary directory.
    A rank that raises makes spawn raise, with its traceback."""
    devices = list(devices)
    if len(devices) != n_ranks:
        raise ValueError(f"spawn: {n_ranks} ranks need {n_ranks} devices, "
                         f"got {devices}")
    if any(torch.device(d).type == "cuda" for d in devices):
        build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        init_file = init_file or os.path.join(tmp, "rendezvous")
        mp.start_processes(
            _rank_main, args=(fn, n_ranks, backend, devices, init_file, args,
                              tmp, timeout_s),
            nprocs=n_ranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
