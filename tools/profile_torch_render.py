"""Where the port's forward render spends its time on the GPU.

Profiles one ``akari_torch`` render of a built-in scene (the Cornell box,
or the procedural terrain, whose ``auto`` route is the tree walk above
4,096 triangles) with ``torch.profiler`` (CPU + CUDA activities) after a
warm-up render, and prints one JSON object: wall time without and with
the profiler, device busy time and idle share (against the profiled wall
time), the number of kernel launches, the dense and tree intersection
kernels' launches and device time, and the top kernels by device time.
Needs a CUDA device; fails without one.

Usage: python tools/profile_torch_render.py [--scene cornell|terrain]
       [--terrain-n 512] [--res 256] [--spp 4] [--max-depth 5]
       [--trace trace.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=["cornell", "terrain"], default="cornell")
    ap.add_argument("--terrain-n", type=int, default=512,
                    help="terrain grid size (2 (n-1)^2 + 2 triangles)")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_render: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.scene.builtin import cornell_box, terrain_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if args.scene == "terrain":
        sc = terrain_scene(args.res, args.res, n=args.terrain_n)
    else:
        sc = cornell_box(args.res, args.res)
    scene = sc.compile().to(dev)
    cfg = PathConfig(spp=args.spp, max_depth=args.max_depth)
    render(scene, sc.camera, cfg, seed=0)  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        render(scene, sc.camera, cfg, seed=0)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 3

    di.reset_launches()
    ti.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(scene, sc.camera, cfg, seed=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3  # us -> ms
    dense_ms = sum(
        e.device_time_total for e in kernels if "dense_intersect_kernel" in e.name
    ) / 1e3
    tree_ms = sum(
        e.device_time_total for e in kernels if "tree_intersect_kernel" in e.name
    ) / 1e3
    by_name = {}
    for e in kernels:
        agg = by_name.setdefault(e.name, [0, 0.0])
        agg[0] += 1
        agg[1] += e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
    paths = args.res * args.res * args.spp
    result = {
        "card": card,
        "workload": (
            f"{args.scene} {scene.n_tris} tris, intersector {scene.intersector}, "
            f"{args.res}x{args.res} spp {args.spp} depth {args.max_depth}"
        ),
        "wall_ms_unprofiled": plain_wall_ms,
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if kernels else "not measured",
        "kernel_launches": len(kernels),
        "dense_kernel_launches": di.LAUNCHES["closest"] + di.LAUNCHES["any_hit"],
        "dense_kernel_ms": dense_ms,
        "tree_kernel_launches": ti.LAUNCHES["closest"] + ti.LAUNCHES["any_hit"],
        "tree_kernel_ms": tree_ms,
        "tree_kernel_share_of_busy": (tree_ms / busy_ms) if kernels else "not measured",
        "mpaths_per_s_unprofiled": paths / (plain_wall_ms / 1e3) / 1e6,
        "top_kernels": [
            {"name": name[:90], "count": c, "ms": ms} for name, (c, ms) in top
        ],
    }
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
