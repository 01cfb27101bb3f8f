"""Where the port's forward render spends its time on the GPU.

Profiles one ``akari_torch`` render of a built-in scene (the Cornell box;
the procedural terrain, whose ``auto`` route is the tree walk above 4,096
triangles; ``instanced-forest128``, 128 copies of the 32,258-triangle
terrain that ``auto`` compiles two-level; or ``envtex``, the env-lit
textured terrain that ``write_envtex_terrain`` writes as OBJ + PNG + .hdr
+ .akari, read back through the SDL) with ``torch.profiler`` (CPU + CUDA
activities) after a warm-up render, through the path tracer, BDPT
(``--integrator bdpt``: ``BDPTConfig(spp)`` with its default depths) or AO
(``--integrator ao``), and prints one JSON object: wall
time without and with the profiler, device busy time and idle share
(against the profiled wall time), the number of kernel launches, each
traversal kernel's launches, device time and share of busy time, and the
top kernels by device time. Needs a CUDA device; fails without one.

With ``--backward`` it profiles one fwd + bwd step of the bench loss
instead (``loss_and_image`` against a zero target, the gradient with
respect to the texel values, as ``bench.py:43-91`` measures), in two
windows, the forward with the graph recorded and the backward, and adds
the backward's time in ``index_add`` kernels (the backward of the row
gathers ``index_select``).

Usage: python tools/profile_torch_render.py
       [--scene cornell|terrain|instanced|envtex] [--integrator path|bdpt|ao]
       [--terrain-n 512] [--res 256] [--spp 4] [--max-depth 5]
       [--backward] [--trace trace.json]
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
    ap.add_argument("--scene", choices=["cornell", "terrain", "instanced", "envtex"],
                    default="cornell")
    ap.add_argument("--integrator", choices=["path", "bdpt", "ao"], default="path")
    ap.add_argument("--terrain-n", type=int, default=512,
                    help="terrain grid size (2 (n-1)^2 + 2 triangles)")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--backward", action="store_true",
                    help="profile one fwd+bwd step of the bench loss, not a render")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_render: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from akari_torch.diff.inverse import apply_params, scene_params
    from akari_torch.integrators.ao import AOConfig, render_ao
    from akari_torch.integrators.bdpt import BDPTConfig, render_bdpt
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import instanced_tree_intersect as iti
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.parallel.render import loss_and_image
    from akari_torch.scene import sdl
    from akari_torch.scene.builtin import (
        cornell_box, instanced_forest_scene, terrain_scene, write_envtex_terrain)

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
    elif args.scene == "envtex":
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            sc = sdl.parse_file(write_envtex_terrain(
                tmp, n=args.terrain_n, res=args.res, spp=args.spp, depth=args.max_depth,
            )).exports["scene"]
            scene = sc.compile().to(dev)
    else:
        sc = cornell_box(args.res, args.res)
    if args.scene != "envtex":
        scene = sc.compile().to(dev)
    if args.backward and args.integrator != "path":
        ap.error("--backward profiles the path tracer's bench step")
    cfg = {"path": PathConfig(spp=args.spp, max_depth=args.max_depth),
           "bdpt": BDPTConfig(spp=args.spp),
           "ao": AOConfig(spp=args.spp)}[args.integrator]
    render_fn = {"path": render, "bdpt": render_bdpt, "ao": render_ao}[args.integrator]
    target = torch.zeros((args.res, args.res, 3), device=dev)

    def forward():
        """The forward: a render, or the loss with the graph recorded."""
        if not args.backward:
            return render_fn(scene, sc.camera, cfg, seed=0), None
        p = scene_params(scene)
        p["tex_value"].requires_grad_(True)
        return loss_and_image(apply_params(scene, p), sc.camera, cfg, target)[0], p

    def step():
        out, p = forward()
        if args.backward:
            torch.autograd.grad(out, [p["tex_value"]])

    step()  # warm-up: kernel build, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / 3

    def profiled(fn):
        """(device events, wall ms, profiler) of fn() in one window."""
        for mod, _ in traversal.values():
            mod.reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return events, wall_ms, prof, out

    def stats(events, wall_ms):
        busy_ms = sum(e.device_time_total for e in events) / 1e3  # us -> ms
        per_kernel = {}
        for label, (mod, key) in traversal.items():
            ms = sum(e.device_time_total for e in events if key in e.name) / 1e3
            per_kernel[label] = {
                "launches": sum(mod.LAUNCHES.values()),
                "ms": ms,
                "share_of_busy": (ms / busy_ms) if events else "not measured",
            }
        by_name = {}
        for e in events:
            agg = by_name.setdefault(e.name, [0, 0.0])
            agg[0] += 1
            agg[1] += e.device_time_total / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[: args.top]
        return {
            "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms if events else "not measured",
            "device_idle_share": (1.0 - busy_ms / wall_ms) if events else "not measured",
            "kernel_launches": len(events),
            "traversal_kernels": per_kernel,
            "top_kernels": [{"name": name[:90], "count": c, "ms": ms}
                            for name, (c, ms) in top],
        }

    paths = args.res * args.res * args.spp
    result = {
        "card": card,
        "workload": (
            f"{args.scene} {scene.n_tris} tris, intersector {scene.intersector}, "
            f"{args.integrator}, {args.res}x{args.res} spp {args.spp}"
            + (f" depth {args.max_depth}" if args.integrator == "path" else f" {cfg}")
            + (", fwd+bwd of the bench loss" if args.backward else "")
        ),
        "wall_ms_unprofiled": plain_wall_ms,
        "mpaths_per_s_unprofiled": paths / (plain_wall_ms / 1e3) / 1e6,
    }
    if args.backward:
        ev_f, wall_f, _, (loss, p) = profiled(forward)
        ev_b, wall_b, prof, _ = profiled(lambda: torch.autograd.grad(loss, [p["tex_value"]]))
        fwd, bwd = stats(ev_f, wall_f), stats(ev_b, wall_b)
        busy = sum(e.device_time_total for e in ev_f + ev_b) / 1e3
        index_add = sum(e.device_time_total for e in ev_b if "indexFunc" in e.name) / 1e3
        bwd["index_add_ms"] = index_add
        bwd["index_add_share_of_busy"] = index_add / bwd["device_busy_ms"] if ev_b else (
            "not measured")
        rays = paths * (2 * args.max_depth + 1)
        result.update({
            "rays_per_sec_per_chip_fwd_bwd_unprofiled": rays / (plain_wall_ms / 1e3),
            "step": {
                "wall_ms_profiled": wall_f + wall_b,
                "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / (wall_f + wall_b),
                "kernel_launches": len(ev_f) + len(ev_b),
            },
            "forward": fwd,
            "backward": bwd,
        })
    else:
        events, wall_ms, prof, _ = profiled(step)
        result.update(stats(events, wall_ms))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
