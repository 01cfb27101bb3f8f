"""Where the port's forward render spends its time on the GPU.

Profiles one ``akari_torch`` render of a built-in scene (the Cornell box;
the procedural terrain, whose ``auto`` route is the tree walk above 4,096
triangles; or ``instanced-forest128``, 128 copies of the 32,258-triangle
terrain that ``auto`` compiles two-level) with ``torch.profiler`` (CPU +
CUDA activities) after a warm-up render, and prints one JSON object: wall
time without and with the profiler, device busy time and idle share
(against the profiled wall time), the number of kernel launches, each
traversal kernel's launches, device time and share of busy time, and the
top kernels by device time. Needs a CUDA device; fails without one.

Usage: python tools/profile_torch_render.py [--scene cornell|terrain|instanced]
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
    ap.add_argument("--scene", choices=["cornell", "terrain", "instanced"], default="cornell")
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
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import instanced_tree_intersect as iti
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.scene.builtin import cornell_box, instanced_forest_scene, terrain_scene

    # traversal kernel -> (launch counts, a substring of its device name)
    traversal = {
        "dense": (di, "dense_intersect_kernel"),
        "tree": (ti, "tree_intersect_kernel"),
        "instanced_tree": (iti, "instanced_tree_kernel"),
        "cluster": (ci, "cluster_kernel"),
    }

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    if args.scene == "terrain":
        sc = terrain_scene(args.res, args.res, n=args.terrain_n)
    elif args.scene == "instanced":
        sc = instanced_forest_scene(args.res, args.res)
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

    for mod, _ in traversal.values():
        mod.reset_launches()
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
    per_kernel = {}
    for label, (mod, key) in traversal.items():
        ms = sum(e.device_time_total for e in kernels if key in e.name) / 1e3
        per_kernel[label] = {
            "launches": sum(mod.LAUNCHES.values()),
            "ms": ms,
            "share_of_busy": (ms / busy_ms) if kernels else "not measured",
        }
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
        "traversal_kernels": per_kernel,
        "mpaths_per_s_unprofiled": paths / (plain_wall_ms / 1e3) / 1e6,
        "top_kernels": [
            {"name": name[:90], "count": c, "ms": ms} for name, (c, ms) in top
        ],
    }
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
