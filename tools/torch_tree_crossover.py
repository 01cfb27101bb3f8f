"""Where the tree walk overtakes the dense sweep on the GPU.

For terrains of about 1k, 4k and 16k triangles (``--sizes`` takes the grid
sizes n, 2 (n-1)^2 + 2 triangles each), times on the card, with CUDA
events, the dense closest-hit kernel and the tree closest-hit kernel on the
same 524,288 rays (a 256x256, 4 spp camera wavefront plus as many random
rays from inside the scene's box): the tree kernel alone on the rays as
they come and on coherence-sorted rays, and the whole tree route
(``intersect_soa``: pack + walk). Checks that
both kernels return the same prims, and prints one JSON line per size.
Needs a CUDA device; fails without one.

Usage: python tools/torch_tree_crossover.py [--sizes 24 46 91] [--iters 20]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[24, 46, 91])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_tree_crossover: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from akari_torch.core.v3 import V3
    from akari_torch.integrators.path import camera_rays_soa
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.ops.intersect import intersect_soa
    from akari_torch.ops.ray_sort import sort_keys_soa
    from akari_torch.scene.builtin import terrain_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)

    def ms(fn):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    for n in args.sizes:
        sc = terrain_scene(256, 256, n=n)
        scene = sc.compile(intersector="tree", device=dev)
        n_cam = 256 * 256 * 4
        pix = torch.arange(n_cam, device=dev) % (256 * 256)
        smp = torch.div(torch.arange(n_cam, device=dev), 256 * 256, rounding_mode="floor")
        o1, d1 = camera_rays_soa(sc.camera, 0, smp, pix)
        g = torch.Generator(device=dev).manual_seed(n)
        o2 = torch.rand((n_cam, 3), generator=g, device=dev) * torch.tensor(
            [2.0, 1.2, 2.0], device=dev) - torch.tensor([1.0, 0.0, 1.0], device=dev)
        d2 = torch.randn((n_cam, 3), generator=g, device=dev)
        d2 = d2 / d2.norm(dim=1, keepdim=True)
        o = V3(*(torch.cat([a, o2[:, k]]) for k, a in enumerate(o1)))
        d = V3(*(torch.cat([a, d2[:, k]]) for k, a in enumerate(d1)))
        zero = torch.zeros(2 * n_cam, device=dev)
        tmax = torch.full((2 * n_cam,), di.T_MAX, device=dev)
        rays = di.pack_rays(o, d, zero, tmax).contiguous()
        targs = (scene.tri_tree, scene.tri_blocks, scene.n_tris, scene.tree_leaf_span)
        k = (scene.n_tris + 127) // 128
        key = sort_keys_soa(
            o, d, scene.tri_clusters[:k, 0:3].min(0).values,
            scene.tri_clusters[:k, 3:6].max(0).values, zero, tmax, hint="secondary",
        )
        rays_s = rays[:, torch.argsort(key, stable=True)].contiguous()
        same = torch.equal(di.closest(rays, scene.prim_table)[3], ti.closest(rays, *targs)[3])
        print(json.dumps({
            "card": card,
            "tris": scene.n_tris,
            "rays": rays.shape[1],
            "dense_kernel_ms": ms(lambda: di.closest(rays, scene.prim_table)),
            "tree_kernel_sorted_ms": ms(lambda: ti.closest(rays_s, *targs)),
            "tree_kernel_unsorted_ms": ms(lambda: ti.closest(rays, *targs)),
            "tree_route_ms": ms(lambda: intersect_soa(scene, o, d, zero, tmax)),
            "prims_equal": same,
        }), flush=True)
        if not same:
            print("torch_tree_crossover: dense and tree prims differ", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
