"""Scaling benchmark of the PyTorch port: rays/s of ``render_sharded`` at
1..N ranks (``bench_scaling.py`` for ``akari_torch``).

Cornell ``RES`` x ``RES`` (256), 4 spp, depth 5, one timed frame on every
rank after a warm-up frame, 5 frames a count; a frame's time is the
slowest rank's. The rank counts are those of ``bench_scaling.py``: 1, 2,
N/2 and N for N cards, one rank a card over NCCL. A machine with one card
runs 1 and 2 ranks, the two sharing the card over gloo: then the
efficiency measures how well the ranks' host dispatch overlaps on one
card, not scaling, and every line says so (``"ranks_share_one_card"``).
``--device cpu`` runs 1 and 2 ranks over gloo on the CPU (a rehearsal;
its times are not device times).

Prints one JSON line per rank count, then the efficiency line at the
largest count: rays/s(N) / (N * rays/s(1)).

Usage: python bench_scaling_torch.py [--device cuda|cpu]
"""

import argparse
import json
import os
import sys
import time

RES, SPP, DEPTH, FRAMES = 256, 4, 5, 5


def time_frames(mesh, res):
    """Seconds of each timed frame on this rank, after a warm-up frame."""
    import torch

    from akari_torch.integrators.path import PathConfig
    from akari_torch.parallel import render_sharded
    from akari_torch.scene.builtin import cornell_box

    sc = cornell_box(res, res)
    scene = sc.compile(intersector="auto", device=mesh.device)
    cfg = PathConfig(spp=SPP, max_depth=DEPTH)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)

    render_sharded(scene, sc.camera, cfg, mesh)
    out = []
    for _ in range(FRAMES):
        mesh.barrier()  # every rank starts together
        t0 = time.perf_counter()
        render_sharded(scene, sc.camera, cfg, mesh)
        sync()
        out.append(time.perf_counter() - t0)
    return out


def rank_counts(cards):
    """``bench_scaling.py``'s counts for ``cards`` cards; 1 and 2 on one
    card (or on the CPU, ``cards`` 0)."""
    if cards <= 1:
        return [1, 2]
    return sorted({1, 2, cards // 2, cards})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from akari_torch.parallel.launch import rank_route, spawn_ranks

    cards = torch.cuda.device_count() if args.device == "cuda" else 0
    counts = rank_counts(cards)
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    rays = SPP * RES * RES * (2 * DEPTH + 1)
    results = {}
    for n in counts:
        device, backend, shared = rank_route(args.device, n)
        threads = max(1, (os.cpu_count() or 1) // n) if args.device == "cpu" else None
        per_rank = spawn_ranks(time_frames, n, (RES,), device=device, backend=backend,
                               timeout=900.0, threads=threads)
        frames = [max(ts) for ts in zip(*per_rank)]  # the slowest rank's, per frame
        dt = sorted(frames)[len(frames) // 2]
        results[n] = rays / dt
        print(json.dumps({
            "metric": "rays_per_sec_total", "ranks": n, "value": results[n], "unit": "rays/s",
            "frame_s_median": dt, "frame_s": frames, "backend": backend, "device": kind,
            "cards": cards, "ranks_share_one_card": shared,
            "config": f"cornell {RES}x{RES}, {SPP} spp, depth {DEPTH}, render_sharded",
        }), flush=True)
    top = counts[-1]
    print(json.dumps({
        "metric": "scaling_efficiency", "ranks": top,
        "value": results[top] / (results[1] * top), "unit": "fraction_of_linear",
        "ranks_share_one_card": rank_route(args.device, top)[2],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
