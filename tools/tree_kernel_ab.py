"""A/B of the traversal kernels on one card: an earlier version's CUDA
sources against the working tree's, on the rays of a frame's fused launch.

Unpack the earlier sources into a git-ignored directory first, e.g.

    git archive <commit> akari_torch/kernels/csrc | tar -x -C build/ab_parent
    python3 tools/tree_kernel_ab.py --old-csrc build/ab_parent/akari_torch/kernels/csrc

Kernels: the two tree walks (``tree_intersect``, ``instanced_tree_intersect``)
and the two linear cluster sweeps (``cluster_intersect``). The earlier
sources are those of a commit whose tree walks read the component-major
stores (``tri_blocks``, ``inst_tri_blocks``; the C interface of the working
tree) and whose sweeps are the one-thread-per-ray kernels on the [T, 12]
row layout (``akr_cluster_*(rays, n, supers, clusters, tris, n_tris, ...)``,
``akr_instanced_cluster_*(..., supers, clusters, tris, ...)``). Each build
is fed its own store: the tool makes the row layout from the
component-major store for the earlier sweeps. Every source is built twice
with the port's nvcc flags (``kernels/build.py``); each kernel's ptxas
registers, stack frame and spills are printed, and, where ``cuobjdump``
exists, each kernel function's SASS instruction count in both builds and
whether its instructions are the same (for the tree walks, which the
working tree only refactors).

Rays: the first fused shadow + extension launch (524,288 rays) of a
256x256, 4 spp, depth 5 frame of terrain512 (the flat tree walk and the
flat sweep on its tables) and of instanced-forest128 (the instanced tree
walk and the instanced sweep), captured as ``chip_smoke.py`` captures them.
For each kernel and variant (closest, any-hit) the old and new answers must
be equal bit for bit; then the two versions are timed in turns, old, new,
new, old (CUDA events, ``--iters`` launches each), on all the rays and on
the live rays only (t_max > t_min). Last, the tree-nulled frames (terrain512
and instanced-forest128 at 256x256, 4 spp, depth 5, which route every
closest-hit query through the sweeps) are timed one frame each after a
warm-up, with the earlier sweeps and with the new ones, in turns. Prints
one JSON object (and writes it to ``--out``). Needs a CUDA device; fails
without one.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import difflib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("tree_intersect", "instanced_tree_intersect", "cluster_intersect")
ORDER = ("old", "new", "new", "old")


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


def sass_functions(cuobjdump, path):
    """{kernel (its name and ANY_HIT argument, e.g. ``cluster_kernel<1>``):
    [SASS instructions, addresses and the build's namespace hash dropped]}
    of a library."""
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True)
    if out.returncode != 0:
        return {}
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"([a-z][a-z_]*_kernel)ILb([01])E", m.group(1))
            name = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)
            funcs[name] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            funcs[name].append(re.sub(r"_GLOBAL__N__[0-9a-f]+", "", m.group(1)))
    return funcs


def _opcode(instr):
    return re.sub(r"^@!?U?P\w+\s+", "", instr).split()[0]


def sass_compare(cuobjdump, old_lib, new_lib):
    """Per kernel function: SASS instruction counts of both builds, whether
    the instructions are the same, whether at least their opcode sequence
    is (registers aside), how many instructions differ, and the first few
    differing (old, new) pairs."""
    old, new = sass_functions(cuobjdump, old_lib), sass_functions(cuobjdump, new_lib)
    res = {}
    for fn in sorted(set(old) | set(new)):
        a, b = old.get(fn, []), new.get(fn, [])
        ops = difflib.SequenceMatcher(a=a, b=b, autojunk=False).get_opcodes()
        changed = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in ops if tag != "equal")
        pairs = [(x, y) for tag, i1, i2, j1, j2 in ops if tag != "equal"
                 for x, y in zip(a[i1:i2] or [""], b[j1:j2] or [""])][:8]
        res[fn] = {"old": len(a), "new": len(b), "same": a == b,
                   "same_opcodes": [_opcode(x) for x in a] == [_opcode(y) for y in b],
                   "changed": changed, "first_differences": pairs}
    return res


def row_store(blocks, n):
    """[n, 12] rows (v0.xyz e1.xyz e2.xyz, 3 zero floats) of the first n
    columns of a component-major store: the earlier sweeps' layout."""
    import torch

    pad = torch.zeros((n, 3), dtype=blocks.dtype, device=blocks.device)
    return torch.cat([blocks[:9, :n].T, pad], 1).contiguous()


def old_calls(libs):
    """ctypes callers of the earlier builds: the tree walks with the
    working tree's arguments, the sweeps with the row layout."""
    import torch

    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lt, li, lc = (libs[k] for k in SOURCES)
    lt.akr_tree_closest.argtypes = [vp, i64, vp, vp, i64, i32, i32, vp, vp, vp, vp, i32, vp]
    lt.akr_tree_anyhit.argtypes = [vp, i64, vp, vp, i64, i32, i32, vp, i32, vp]
    li.akr_instanced_tree_closest.argtypes = [
        vp, i64, vp, vp, i32, vp, vp, i64, i32, vp, vp, vp, vp, i32, vp]
    li.akr_instanced_tree_anyhit.argtypes = [vp, i64, vp, vp, i32, vp, vp, i64, i32, vp, i32, vp]
    lc.akr_cluster_closest.argtypes = [vp, i64, vp, vp, vp, i32, vp, vp, vp, vp, i32, vp]
    lc.akr_cluster_anyhit.argtypes = [vp, i64, vp, vp, vp, i32, vp, i32, vp]
    lc.akr_instanced_cluster_closest.argtypes = [
        vp, i64, vp, vp, i32, vp, vp, vp, vp, vp, vp, vp, i32, vp]
    lc.akr_instanced_cluster_anyhit.argtypes = [vp, i64, vp, vp, i32, vp, vp, vp, vp, i32, vp]

    def run(fn, rays, args, any_hit):
        n, dev = rays.shape[1], rays.device
        out = ((torch.empty(n, dtype=torch.bool, device=dev),) if any_hit else
               tuple(torch.empty(n, dtype=dt, device=dev)
                     for dt in (torch.float32, torch.float32, torch.float32, torch.int32)))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(rays.data_ptr(), n, *args, *(o.data_ptr() for o in out), dev.index, stream)
        if err:
            raise RuntimeError(f"old kernel launch failed: CUDA error {err}")
        return out[0] if any_hit else out

    def ptr(*xs):
        return tuple(x.data_ptr() for x in xs)

    def tree(rays, nodes, blocks, n_tris, span, any_hit):
        fn = lt.akr_tree_anyhit if any_hit else lt.akr_tree_closest
        return run(fn, rays, (*ptr(nodes, blocks), blocks.shape[1], n_tris, span), any_hit)

    def inst_tree(rays, instf, insti, nodes, blocks, span, any_hit):
        fn = li.akr_instanced_tree_anyhit if any_hit else li.akr_instanced_tree_closest
        args = (*ptr(instf, insti), instf.shape[0], *ptr(nodes, blocks), blocks.shape[1], span)
        return run(fn, rays, args, any_hit)

    def cluster(rays, supers, clusters, rows, any_hit):
        fn = lc.akr_cluster_anyhit if any_hit else lc.akr_cluster_closest
        return run(fn, rays, (*ptr(supers, clusters, rows), rows.shape[0]), any_hit)

    def inst_cluster(rays, instf, insti, supers, clusters, rows, any_hit):
        fn = lc.akr_instanced_cluster_anyhit if any_hit else lc.akr_instanced_cluster_closest
        args = (*ptr(instf, insti), instf.shape[0], *ptr(supers, clusters, rows))
        return run(fn, rays, args, any_hit)

    return tree, inst_tree, cluster, inst_cluster


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
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from chip_smoke import capture_fused, card_line, cuda_ms, ptxas_summary
    from dense_kernel_ab import find_cuobjdump
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.kernels import build as kbuild
    from akari_torch.ops import cluster_intersect as ci
    from akari_torch.ops import instanced_tree_intersect as iti
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.scene.builtin import instanced_forest_scene, terrain_scene

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cuobjdump = find_cuobjdump()
    ptxas, sass, old_libs = {}, {}, {}
    for name in SOURCES:  # the new ones run through their wrappers (kernels/build.py)
        kbuild.load(name)
        new_lib, rep = build_lib(kbuild.CSRC, name, "new")
        ptxas[f"{name} (new)"] = ptxas_summary(rep)
        old_lib, rep = build_lib(args.old_csrc, name, "old")
        ptxas[f"{name} (old)"] = ptxas_summary(rep)
        old_libs[name] = ctypes.CDLL(old_lib)
        sass[name] = (sass_compare(cuobjdump, old_lib, new_lib) if cuobjdump
                      else "cuobjdump not found on this machine")
    old_tree, old_inst, old_cl, old_icl = old_calls(old_libs)
    for k, v in ptxas.items():
        print(f"{k}:\n  " + v.replace("\n", "\n  "), flush=True)
    print(f"SASS, old vs new: {json.dumps(sass, indent=1)}", flush=True)
    build_s = time.perf_counter() - t0

    cfg = PathConfig(spp=4, max_depth=5)
    sc_t = terrain_scene(256, 256, n=512)
    terrain = sc_t.compile().to(dev)
    sc_f = instanced_forest_scene(256, 256)
    forest = sc_f.compile().to(dev)
    rays_t = capture_fused(ti, "closest", lambda: render(terrain, sc_t.camera, cfg, seed=0))
    rays_f = capture_fused(iti, "closest", lambda: render(forest, sc_f.camera, cfg, seed=0))

    t_rows = row_store(terrain.tri_blocks, terrain.n_tris)
    f_rows = row_store(forest.inst_tri_blocks, forest.inst_tri_blocks.shape[1])
    tnew = (terrain.tri_tree, terrain.tri_blocks, terrain.n_tris, terrain.tree_leaf_span)
    fnew = (forest.inst_f32, forest.inst_i32, forest.tri_tree, forest.inst_tri_blocks,
            forest.tree_leaf_span)
    tboxes = (terrain.tri_superclusters, terrain.tri_clusters)
    fboxes = (forest.inst_f32, forest.inst_i32, forest.tri_superclusters, forest.tri_clusters)
    cases = {
        "tree": (rays_t, lambda r, a: old_tree(r, *tnew, a),
                 lambda r, a: (ti.any_hit if a else ti.closest)(r, *tnew)),
        "instanced_tree": (rays_f, lambda r, a: old_inst(r, *fnew, a),
                           lambda r, a: (iti.any_hit if a else iti.closest)(r, *fnew)),
        "cluster": (rays_t, lambda r, a: old_cl(r, *tboxes, t_rows, a),
                    lambda r, a: (ci.any_hit if a else ci.closest)(
                        r, *tboxes, terrain.tri_blocks, terrain.n_tris)),
        "instanced_cluster": (rays_f, lambda r, a: old_icl(r, *fboxes, f_rows, a),
                              lambda r, a: (ci.instanced_any_hit if a else ci.instanced_closest)(
                                  r, *fboxes, forest.inst_tri_blocks)),
    }
    result = {"card": card, "iters": args.iters, "build_s": build_s, "ptxas": ptxas,
              "sass": sass, "kernels": {}, "frames": {}}
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
                times = {"old": [], "new": []}
                for which in ORDER:
                    fn = old if which == "old" else new
                    times[which].append(cuda_ms(lambda: fn(r, any_hit), iters=args.iters))
                rec[part] = {"old_ms": times["old"], "new_ms": times["new"]}
            result["kernels"][key] = rec
            print(f"{key}: {json.dumps(rec)} [card: {card}]", flush=True)

    # the tree-nulled frames: every closest-hit query through the sweeps
    old_wrappers = {
        "closest": lambda r, sup, cl, blocks, n_tris: old_cl(r, sup, cl, t_rows, False),
        "any_hit": lambda r, sup, cl, blocks, n_tris: old_cl(r, sup, cl, t_rows, True),
        "instanced_closest": lambda r, *a: old_icl(r, *a[:4], f_rows, False),
        "instanced_any_hit": lambda r, *a: old_icl(r, *a[:4], f_rows, True),
    }
    new_wrappers = {k: getattr(ci, k) for k in old_wrappers}
    frames = {"terrain512_tree_nulled": (dataclasses.replace(terrain, tri_tree=None), sc_t),
              "forest128_tree_nulled": (dataclasses.replace(forest, tri_tree=None), sc_f)}
    try:
        for label, (scene, sc) in frames.items():
            times = {"old": [], "new": []}
            for which in ORDER:
                for k, fn in (old_wrappers if which == "old" else new_wrappers).items():
                    setattr(ci, k, fn)
                times[which].append(cuda_ms(lambda: render(scene, sc.camera, cfg, seed=0),
                                            iters=1, warmup=1))
            result["frames"][label] = {"old_ms": times["old"], "new_ms": times["new"]}
            print(f"frame {label} (256x256, 4 spp, depth 5): "
                  f"{json.dumps(result['frames'][label])} [card: {card}]", flush=True)
    finally:
        for k, fn in new_wrappers.items():
            setattr(ci, k, fn)
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
