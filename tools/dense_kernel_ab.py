"""A/B of the dense intersection kernels on one card: an earlier version's
CUDA source against the working tree's, on three ray sets.

Unpack the earlier source into a git-ignored directory first, e.g.

    git archive <commit> akari_torch/kernels/csrc | tar -x -C build/ab_parent
    python3 tools/dense_kernel_ab.py --old-csrc build/ab_parent/akari_torch/kernels/csrc

Both sources have the same C interface (``akr_dense_closest``,
``akr_dense_anyhit``). Two builds, each with the port's nvcc flags
(``kernels/build.py``): ``old`` (the earlier source) and ``new`` (the
working tree's). ``RAYS_PER_THREAD`` (1 for a kernel from before the
Hopper redesign, 2 for the redesign) turns instruction counts into counts
per test. Each kernel's ptxas registers, stack frame and spills are
printed; where ``cuobjdump`` exists, so is the SASS
instruction count of one pass of each kernel's inner triangle loop (the
smallest backward branch whose body holds at least one triangle's
shared-memory loads), per triangle and per ray-triangle test (36 bytes of
shared loads a triangle in both designs).

Ray sets, on the Cornell box (36 triangles):

- ``cornell256``: the first fused shadow + extension launch (524,288 rays)
  of a 256x256, 4 spp, depth 5 frame, captured as ``chip_smoke.py``
  captures it;
- ``cornell1024``: the first fused launch (8,388,608 rays) of a 1024x1024,
  16 spp, depth 5 frame;
- ``make_rays``: the first 524,288 rays of ``chip_smoke.py``'s make_rays
  pack (a quarter camera rays, the rest random rays inside the box; a
  third dead, a third bounded to half their hit distance).

For each set and variant (closest, any-hit) the new build's answers must
equal the old kernel's bit for bit, and on ``chip_smoke.adversarial_pack``
too (untimed); then the builds are timed in turns, old, new, new, old
(CUDA events over ``--iters`` launches run back to back,
``chip_smoke.cuda_ms``). The live-ray count of each set is
reported. Prints one JSON object (and writes it to ``--out``). Needs a
CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "dense_intersect"
BUILDS = ("old", "new")
RAYS_PER_THREAD = {"old": 1, "new": 2}
TRI_LOAD_BYTES = 36  # shared-memory bytes a triangle's test loads
ORDER = ("old", "new", "new", "old")


def build_lib(csrc, tag):
    """nvcc ``csrc/dense_intersect.cu`` with the port's flags into
    build/dense_kernel_ab/; (library path, ptxas report)."""
    from akari_torch.kernels import build as kbuild

    out_dir = os.path.join(kbuild.REPO_ROOT, "build", "dense_kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{NAME}_{tag}.so")
    cmd = [kbuild.find_nvcc(), *kbuild.NVCC_FLAGS, "-o", lib,
           os.path.join(csrc, NAME + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{proc.stderr}")
    return lib, proc.stderr


def callers(path):
    """(closest, any_hit) over the C interface of one build."""
    import torch

    lib = ctypes.CDLL(path)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.akr_dense_closest.argtypes = [vp, i64, vp, i32, i32, vp, vp, vp, vp, i32, vp]
    lib.akr_dense_closest.restype = i32
    lib.akr_dense_anyhit.argtypes = [vp, i64, vp, i32, i32, vp, i32, vp]
    lib.akr_dense_anyhit.restype = i32

    def stream(rays):
        return torch.cuda.current_stream(rays.device).cuda_stream

    def closest(rays, tris):
        n, dev = rays.shape[1], rays.device
        out = [torch.empty(n, dtype=dt, device=dev)
               for dt in (torch.float32, torch.float32, torch.float32, torch.int32)]
        err = lib.akr_dense_closest(rays.data_ptr(), n, tris.data_ptr(), tris.shape[0],
                                    tris.stride(0), *(o.data_ptr() for o in out),
                                    dev.index, stream(rays))
        if err:
            raise RuntimeError(f"closest launch failed: CUDA error {err}")
        return tuple(out)

    def any_hit(rays, tris):
        occ = torch.empty(rays.shape[1], dtype=torch.bool, device=rays.device)
        err = lib.akr_dense_anyhit(rays.data_ptr(), rays.shape[1], tris.data_ptr(),
                                   tris.shape[0], tris.stride(0), occ.data_ptr(),
                                   rays.device.index, stream(rays))
        if err:
            raise RuntimeError(f"any-hit launch failed: CUDA error {err}")
        return occ

    return closest, any_hit


def find_cuobjdump():
    from akari_torch.kernels import build as kbuild

    on_path = shutil.which("cuobjdump")
    if on_path:
        return on_path
    beside = os.path.join(os.path.dirname(kbuild.find_nvcc()), "cuobjdump")
    return beside if os.path.isfile(beside) else None


INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def inner_loop(sass_lines):
    """The smallest loop (backward branch) whose body holds at least one
    triangle's shared loads: its instruction count, its LDS instructions
    and their bytes."""
    instrs, labels, pending = [], {}, []
    for line in sass_lines:
        m = LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            instrs.append((addr, m.group(2)))
    best = None
    for addr, text in instrs:
        op = re.sub(r"^@!?U?P\w+\s+", "", text).split()
        if not op or op[0].split(".")[0] != "BRA":
            continue
        tgt = re.search(r"0x([0-9a-f]+)|(\.L_x_\d+)", text)
        if not tgt:
            continue
        target = int(tgt.group(1), 16) if tgt.group(1) else labels.get(tgt.group(2))
        if target is None or target > addr:
            continue
        body = [t for a, t in instrs if target <= a <= addr]
        lds = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in body]
        lds = [o for o in lds if o.split(".")[0] == "LDS"]
        width = sum(16 if ".128" in o else 8 if ".64" in o else 4 for o in lds)
        if width >= TRI_LOAD_BYTES and (best is None or len(body) < best["instructions"]):
            best = {"instructions": len(body), "lds": len(lds), "lds_bytes": width}
    return best


def sass_counts(cuobjdump, path, rays_per_thread):
    """Per kernel function of the library: its inner loop's counts, the
    triangles one pass tests, instructions per triangle and per test."""
    out = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True)
    if out.returncode != 0:
        return {"error": out.stderr.strip()[-400:]}
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name:
            funcs[name].append(line)
    res = {}
    for fname, lines in funcs.items():
        loop = inner_loop(lines)
        if loop is None:
            continue
        kind = "any_hit" if "ILb1E" in fname else "closest"
        tris = loop["lds_bytes"] / TRI_LOAD_BYTES
        loop["triangles_per_pass"] = tris
        loop["per_triangle"] = loop["instructions"] / tris
        loop["per_test"] = loop["per_triangle"] / rays_per_thread
        res[kind] = loop
    return res


def same(a, b):
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", required=True, help="directory of the earlier kernel source")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("dense_kernel_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import (N_RAYS, FUSED_RAYS, adversarial_pack, capture_fused, card_line,
                            cuda_ms, make_rays, ptxas_summary)
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.kernels import build as kbuild
    from akari_torch.ops import dense_intersect as di
    from akari_torch.scene.builtin import cornell_box

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    cuobjdump = find_cuobjdump()
    ptxas, sass, fns = {}, {}, {}
    for tag in BUILDS:
        csrc = args.old_csrc if tag == "old" else kbuild.CSRC
        lib, report = build_lib(csrc, tag)
        ptxas[tag] = ptxas_summary(report)
        sass[tag] = (sass_counts(cuobjdump, lib, RAYS_PER_THREAD[tag]) if cuobjdump
                     else "cuobjdump not found on this machine")
        fns[tag] = callers(lib)
        print(f"{tag}:\n  " + ptxas[tag].replace("\n", "\n  ")
              + f"\n  inner loop SASS: {json.dumps(sass[tag])}", flush=True)
    build_s = time.perf_counter() - t0

    sc = cornell_box(256, 256)
    scene = sc.compile().to(dev)
    tris = scene.prim_table
    sc1k = cornell_box(1024, 1024)
    scene1k = sc1k.compile().to(dev)
    n1k = 2 * 1024 * 1024 * 4  # shadow + extension rays of 4 spp in flight
    sets = {
        "cornell256": capture_fused(di, "closest", lambda: render(
            scene, sc.camera, PathConfig(spp=4, max_depth=5), seed=0)),
        "cornell1024": capture_fused(di, "closest", lambda: render(
            scene1k, sc1k.camera, PathConfig(spp=16, max_depth=5), seed=0), n_rays=n1k),
        "make_rays": make_rays(scene, sc.camera, N_RAYS, 0, torch)[:, :FUSED_RAYS].contiguous(),
    }
    del scene1k
    result = {"card": card, "iters": args.iters, "build_s": build_s, "ptxas": ptxas,
              "sass_inner_loop": sass, "sets": {}}
    adv_rays, adv_tris = adversarial_pack(dev, torch)
    result["adversarial_equal_to_old"] = {
        tag: [same(fns["old"][v](adv_rays, adv_tris), fns[tag][v](adv_rays, adv_tris))
              for v in (0, 1)] for tag in BUILDS if tag != "old"}
    print(f"adversarial pack, (closest, any-hit) equal to old: "
          f"{result['adversarial_equal_to_old']}", flush=True)
    ok = all(all(x) for x in result["adversarial_equal_to_old"].values())
    for label, rays in sets.items():
        live_closest = int((rays[6] < torch.clamp(rays[7], max=di.T_MAX)).sum())
        live_any = int((rays[6] < rays[7]).sum())
        rec = {"rays": rays.shape[1], "live_rays_closest": live_closest,
               "live_rays_any_hit": live_any}
        for v, variant in enumerate(("closest", "any_hit")):
            ref = fns["old"][v](rays, tris)
            equal = {tag: same(ref, fns[tag][v](rays, tris)) for tag in BUILDS if tag != "old"}
            ok &= all(equal.values())
            times = {tag: [] for tag in BUILDS}
            for tag in ORDER:
                fn = fns[tag][v]
                times[tag].append(cuda_ms(lambda: fn(rays, tris), iters=args.iters))
            rec[variant] = {"equal_to_old": equal, "ms": times}
            print(f"{label} {variant}: {json.dumps(rec[variant])} [card: {card}]", flush=True)
        result["sets"][label] = rec
        print(f"{label}: {rays.shape[1]} rays, {live_closest} live (closest), {live_any} live "
              f"(any-hit)", flush=True)
        torch.cuda.empty_cache()
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
