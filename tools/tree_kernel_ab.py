"""A/B of the two tree-walk kernels on one card: an earlier version's CUDA
sources against the working tree's, on the rays of a frame's fused launch.

Unpack the earlier sources into a git-ignored directory first, e.g.

    git archive <commit> akari_torch/kernels/csrc | tar -x -C build/ab_parent
    python3 tools/tree_kernel_ab.py --old-csrc build/ab_parent/akari_torch/kernels/csrc

The earlier sources are the one-thread-per-ray kernels with the [T, 12] row
stores (``tree_tris``, ``inst_tris``) and their C interface; the working
tree's are the warp-cooperative kernels on the component-major stores
(``tri_blocks``, ``inst_tri_blocks``). Both are built with the port's nvcc
flags (``kernels/build.py``), and each kernel's ptxas registers, stack frame
and spills are printed.

Rays: the first fused shadow + extension launch (524,288 rays) of a 256x256,
4 spp, depth 5 frame of terrain512 (flat tree kernel) and of
instanced-forest128 (instanced tree kernel), captured as ``chip_smoke.py``
captures them. For each kernel and variant (closest, any-hit) the old and
new answers must be equal bit for bit; then the two versions are timed in
turns, old, new, new, old (CUDA events, ``--iters`` launches each), on all
the rays and again on the live rays only (t_max > t_min), which splits the
dead lanes' cost from the rest. Prints one JSON object (and writes it to
``--out``). Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("tree_intersect", "instanced_tree_intersect")


def build_lib(csrc, name, tag):
    """nvcc ``csrc/<name>.cu`` with the port's flags into
    build/tree_kernel_ab/; (library path, ptxas report)."""
    from akari_torch.kernels import build as kbuild

    out_dir = os.path.join(kbuild.REPO_ROOT, "build", "tree_kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
    cmd = [kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-o", lib, os.path.join(csrc, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag} {name}:\n{proc.stderr}")
    return lib, proc.stderr


def old_calls(lib_tree, lib_inst):
    """ctypes callers of the earlier C interface (row stores)."""
    import torch

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib_tree.akr_tree_closest.argtypes = [vp, i64, vp, vp, i32, i32, vp, vp, vp, vp, i32, vp]
    lib_tree.akr_tree_anyhit.argtypes = [vp, i64, vp, vp, i32, i32, vp, i32, vp]
    lib_inst.akr_instanced_tree_closest.argtypes = [
        vp, i64, vp, vp, i32, vp, vp, i32, vp, vp, vp, vp, i32, vp]
    lib_inst.akr_instanced_tree_anyhit.argtypes = [vp, i64, vp, vp, i32, vp, vp, i32, vp, i32, vp]

    def outputs(rays, any_hit):
        n, dev = rays.shape[1], rays.device
        if any_hit:
            return (torch.empty(n, dtype=torch.bool, device=dev),)
        return tuple(torch.empty(n, dtype=dt, device=dev)
                     for dt in (torch.float32, torch.float32, torch.float32, torch.int32))

    def run(fn, rays, head, tail, any_hit):
        out = outputs(rays, any_hit)
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        err = fn(rays.data_ptr(), rays.shape[1], *head, *tail,
                 *(o.data_ptr() for o in out), rays.device.index, stream)
        if err:
            raise RuntimeError(f"old kernel launch failed: CUDA error {err}")
        return out[0] if any_hit else out

    def tree(rays, nodes, rows, span, any_hit):
        fn = lib_tree.akr_tree_anyhit if any_hit else lib_tree.akr_tree_closest
        return run(fn, rays, (nodes.data_ptr(), rows.data_ptr()), (rows.shape[0], span), any_hit)

    def inst(rays, instf, insti, nodes, rows, span, any_hit):
        fn = lib_inst.akr_instanced_tree_anyhit if any_hit else lib_inst.akr_instanced_tree_closest
        head = (instf.data_ptr(), insti.data_ptr(), instf.shape[0], nodes.data_ptr(),
                rows.data_ptr())
        return run(fn, rays, head, (span,), any_hit)

    return tree, inst


def same(a, b):
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", required=True, help="directory of the earlier kernel sources")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tree_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import capture_fused, card_line, cuda_ms, ptxas_summary
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.kernels import build as kbuild
    from akari_torch.ops import instanced_tree_intersect as iti
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.scene.builtin import instanced_forest_scene, terrain_scene

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    ptxas, old_libs = {}, []
    for name in SOURCES:  # the new ones run through their wrappers (kernels/build.py)
        kbuild.load(name)
        ptxas[f"{name} (new)"] = ptxas_summary(build_lib(kbuild.CSRC, name, "new")[1])
        lib, rep = build_lib(args.old_csrc, name, "old")
        ptxas[f"{name} (old)"] = ptxas_summary(rep)
        old_libs.append(ctypes.CDLL(lib))
    old_tree, old_inst = old_calls(*old_libs)
    for k, v in ptxas.items():
        print(f"{k}:\n  " + v.replace("\n", "\n  "), flush=True)
    build_s = time.perf_counter() - t0

    cfg = PathConfig(spp=4, max_depth=5)
    sc_t = terrain_scene(256, 256, n=512)
    terrain = sc_t.compile().to(dev)
    sc_f = instanced_forest_scene(256, 256)
    forest = sc_f.compile().to(dev)
    rays_t = capture_fused(ti, "closest", lambda: render(terrain, sc_t.camera, cfg, seed=0))
    rays_f = capture_fused(iti, "closest", lambda: render(forest, sc_f.camera, cfg, seed=0))

    tnew = (terrain.tri_tree, terrain.tri_blocks, terrain.n_tris, terrain.tree_leaf_span)
    fnew = (forest.inst_f32, forest.inst_i32, forest.tri_tree, forest.inst_tri_blocks,
            forest.tree_leaf_span)
    cases = {
        "tree": (rays_t,
                 lambda r, a: old_tree(r, terrain.tri_tree, terrain.tree_tris,
                                       terrain.tree_leaf_span, a),
                 lambda r, a: (ti.any_hit if a else ti.closest)(r, *tnew)),
        "instanced_tree": (rays_f,
                           lambda r, a: old_inst(r, forest.inst_f32, forest.inst_i32,
                                                 forest.tri_tree, forest.inst_tris,
                                                 forest.tree_leaf_span, a),
                           lambda r, a: (iti.any_hit if a else iti.closest)(r, *fnew)),
    }
    result = {"card": card, "iters": args.iters, "build_s": build_s, "ptxas": ptxas,
              "kernels": {}}
    ok = True
    for label, (rays, old, new) in cases.items():
        live = rays[:, rays[7] > rays[6]].contiguous()
        for any_hit in (False, True):
            key = f"{label}_{'any_hit' if any_hit else 'closest'}"
            equal = same(old(rays, any_hit), new(rays, any_hit))
            ok &= equal
            rec = {"rays": rays.shape[1], "live_rays": live.shape[1],
                   "old_equals_new": equal}
            for part, r in (("all", rays), ("live", live)):
                order = []
                for which in ("old", "new", "new", "old"):
                    fn = old if which == "old" else new
                    order.append((which, cuda_ms(lambda: fn(r, any_hit), iters=args.iters)))
                rec[part] = {"old_ms": [m for w, m in order if w == "old"],
                             "new_ms": [m for w, m in order if w == "new"]}
            result["kernels"][key] = rec
            print(f"{key}: {json.dumps(rec)} [card: {card}]", flush=True)
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
