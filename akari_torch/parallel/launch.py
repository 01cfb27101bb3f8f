"""Spawn the ranks of a ray mesh on one host and gather their results.

``spawn_ranks(fn, world_size, ...)`` starts one process per rank (the
``spawn`` start method), joins them through a ``file://`` rendezvous,
calls ``fn(mesh, *args)`` in each and returns the ranks' results in rank
order. A rank that raises, exits without a result or outlives
``timeout`` fails the whole call: the others are killed and
``RankFailure`` carries the failing rank's traceback.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback


def rank_route(device, ranks):
    """(device, backend, whether ranks share a card) for ``ranks`` ranks on
    ``device`` ("cuda" or "cpu"): one card a rank over NCCL while the cards
    suffice; several ranks sharing a machine's one card over gloo (NCCL
    refuses two ranks on one GPU); gloo on the CPU."""
    import torch

    if device == "cpu":
        return "cpu", "gloo", False
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available")
    if ranks <= cards:
        return "cuda", "nccl", False
    if cards != 1:
        raise ValueError(f"{ranks} ranks on {cards} cards: give each rank its own card, "
                         "or share one card")
    return "cuda:0", "gloo", True


def local_ranks(device):
    """The ranks a ray mesh on ``device`` spans when the process was not
    started by ``torch.distributed.run`` (no ``WORLD_SIZE``): one a card on
    ``cuda`` with more than one card seen, as the reference's
    ``make_ray_mesh()`` spans every local device; else 1."""
    import torch

    if "WORLD_SIZE" in os.environ or torch.device(device).type != "cuda":
        return 1
    return max(1, torch.cuda.device_count())


class RankFailure(RuntimeError):
    """A rank of ``spawn_ranks`` failed, timed out or died."""


def _rank_main(fn, rank, world_size, init_method, device, backend, threads, args, results):
    import torch
    import torch.distributed as dist

    from .mesh import initialize_distributed

    os.environ["LOCAL_RANK"] = str(rank)  # one host: "cuda" is cuda:{rank}
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = initialize_distributed(device=device, backend=backend, init_method=init_method,
                                      world_size=world_size, rank=rank)
        try:
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def spawn_ranks(fn, world_size, args=(), *, device="cuda", backend=None, timeout=120.0,
                threads=None, rendezvous_dir=None):
    """[fn(mesh, *args) of rank 0, ..., of rank world_size - 1].

    ``fn`` must be importable by name (the ranks are spawned) and return
    picklable values (NumPy arrays, not tensors). ``device`` and
    ``backend`` go to ``initialize_distributed`` in every rank: ``cuda``
    is one card a rank over NCCL; several ranks sharing one card pass
    ``device="cuda:0", backend="gloo"``. ``threads`` sets each rank's
    ``torch.set_num_threads``. The rendezvous file lives in
    ``rendezvous_dir`` (a new temporary directory if None), which must
    not hold one of an earlier call.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init_method, device, backend, threads,
                                   args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        try:
            out = _gather(procs, results, world_size, time.monotonic() + timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    return out


def _gather(procs, results, world_size, deadline):
    """The ranks' results in rank order; raises on the first failure."""
    got, dead_seen = {}, False
    while len(got) < world_size:
        try:
            # after a rank is seen dead, one more wait drains what it wrote
            rank, ok, payload = results.get(timeout=5.0 if dead_seen else 1.0)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs) if r not in got and p.exitcode is not None]
            if dead and dead_seen:
                raise RankFailure(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                                  "before returning a result") from None
            dead_seen = bool(dead)
            if time.monotonic() > deadline:
                missing = sorted(set(range(world_size)) - set(got))
                raise RankFailure(f"ranks {missing} timed out") from None
            continue
        if not ok:
            raise RankFailure(f"rank {rank} failed:\n{payload}")
        got[rank] = payload
    for r, p in enumerate(procs):
        p.join(timeout=max(1.0, deadline - time.monotonic()))
        if p.exitcode != 0:
            raise RankFailure(f"rank {r} exited with code {p.exitcode}")
    return [got[r] for r in range(world_size)]
