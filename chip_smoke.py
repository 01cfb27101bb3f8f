"""GPU smoke run of the PyTorch / CUDA port (``akari_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each checks its results; any failure exits non-zero):

1. setup: the card's name and power limit; build the CUDA kernels from
   ``akari_torch/kernels/csrc`` and report the build time;
2. kernel vs plain PyTorch version on the card, on >= 2^20 rays against
   the compiled Cornell box and a 300-triangle soup (prim/valid exact,
   t/u/v bit-exact or within 2 ulp; any-hit == closest-hit validity);
3. the main path at the bench width: ``render`` of the 256x256 Cornell
   box, 4 spp, depth 5, with launch counts (1 + max_depth per
   ``trace_paths`` call) and a lit, finite image;
4. cross-framework check: 64x64, 4 spp, depth 5, seed 0 against the
   golden image rendered by the JAX package
   (tests/data/torch_port_cornell64_spp4_d5.npy);
5. realistic size: 1024x1024, 16 spp, depth 5 through ``render`` and
   through the CLI, timed after a warm-up, plus the kernel alone and its
   plain version alone at the fused launch's shape (524,288 rays);
6. tree kernel vs plain walk on the card: both variants on >= 2^18 + 77
   rays against the 522,244-triangle terrain (native BVH builder) and a
   20k-triangle soup with exact duplicates across clusters (prim/valid
   exact, t/u/v within 2 ulp; any-hit == closest validity == the dense
   plain version's on 65,536 soup rays);
7. the large-scene main path: ``render`` of ``terrain_scene(256, 256,
   n=512)`` on ``auto``, 4 spp, depth 5, through the tree kernel only
   (1 + max_depth launches per ``trace_paths``, no dense launch), with
   frame time, path and ray rates, peak memory and the host compile time;
8. the 64x64 terrain (7,940 triangles, tree route) against the JAX
   package's golden (tests/data/torch_port_terrain64_spp4_d5.npy);
9. the 2,093,060-triangle terrain on ``auto``, compile time included;
10. the CLI on a large OBJ: the n=512 terrain and its light written as
    OBJ + MTL + .akari, rendered at 256x256, 4 spp;
11. tree kernel and plain walk times at the fused launch's shape (524,288
    rays captured from a render's first bounce), on the rays as the main
    path launches them and sorted by the reference's coherence key;
12. the result: a JSON line of kernel records, then the device line.

Every kernel source (and the native BVH builder) is built at start, one
compiler process each, all started together. Imports nothing of JAX.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_cornell64_spp4_d5.npy")
TERRAIN_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_terrain64_spp4_d5.npy")
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")

N_RAYS = (1 << 20) + 77          # not a multiple of any block size
TREE_RAYS = (1 << 18) + 77       # tree kernel vs plain walk
SOUP_SUBSET = 65_536             # tree vs dense plain version on the soup
FUSED_RAYS = 2 * 256 * 256 * 4   # shadow + extension rays of one bounce
MEAN_LIT_MIN = 0.05              # "clearly lit" bound on the mean radiance
KERNELS = ("dense_intersect", "tree_intersect")


def log(msg):
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    """Fail the run (an exception, so it holds under python -O too)."""
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a, b):
    """Max ulp distance between two float32 tensors over unequal lanes
    (-0.0 == 0.0 counts as equal)."""
    import torch

    neq = a != b
    if not bool(neq.any()):
        return 0
    ia = a[neq].contiguous().view(torch.int32).to(torch.int64)
    ib = b[neq].contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max())


def cuda_ms(fn, iters, warmup=3):
    """Mean milliseconds per call of fn() on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def images_match(a, b, rtol=1e-3, atol=2e-3, outlier_frac=0.08, mean_tol=3e-3):
    """The outlier-budget image comparison of tests/_imgcmp.py."""
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    check(a.shape == b.shape, f"shapes {a.shape} != {b.shape}")
    d = np.abs(a - b)
    frac = float((d > (atol + rtol * np.abs(b))).mean())
    mean = float(d.mean())
    log(f"  outlier frac {frac:.5f} (budget {outlier_frac}), "
        f"mean abs diff {mean:.3e} (budget {mean_tol}), max {d.max():.4g}")
    check(frac <= outlier_frac, f"outlier fraction {frac} > {outlier_frac}")
    check(mean <= mean_tol, f"mean abs diff {mean} > {mean_tol}")


def compare_kernel(name, rays, mod, args, n_tris):
    """Kernel vs plain on the card for a kernel module with the
    ``closest``/``closest_plain``/``any_hit``/``any_hit_plain`` API and
    table arguments ``args``; returns the max |difference| of the
    closest-hit outputs and of the any-hit flags, and the prims."""
    import torch

    t0 = time.perf_counter()
    t_k, u_k, v_k, p_k = mod.closest(rays, *args)
    occ_k = mod.any_hit(rays, *args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    t_p, u_p, v_p, p_p = mod.closest_plain(rays, *args)
    occ_p = mod.any_hit_plain(rays, *args)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(torch.equal(p_k, p_p), f"{name}: prim differs on {int((p_k != p_p).sum())} rays")
    valid = p_k >= 0
    errs, ulps = [], []
    for a, b in ((t_k, t_p), (u_k, u_p), (v_k, v_p)):
        errs.append(float((a - b).abs().max()))
        ulps.append(ulp_diff(a[valid], b[valid]))
    max_err, max_ulp = max(errs), max(ulps)
    check(max_ulp <= 2, f"{name}: t/u/v differ by {max_ulp} ulp")
    check(torch.equal(occ_k, occ_p), f"{name}: any-hit kernel != plain")
    check(torch.equal(occ_k, valid), f"{name}: any-hit != closest.valid")
    occ_err = float((occ_k.float() - occ_p.float()).abs().max())
    n_dead = int((rays[7] <= rays[6]).sum())
    log(f"  {name}: {rays.shape[1]} rays ({n_dead} dead) x {n_tris} "
        f"tris, {int(valid.sum())} hits, prim/valid exact, t/u/v max |diff| {max_err:.3g} "
        f"({max_ulp} ulp), any-hit == closest.valid == plain; kernels {t1 - t0:.3f} s, "
        f"plain {t2 - t1:.3f} s (wall)")
    return max_err, occ_err, p_k


def tree_soup(dev, torch, n=20_000, seed=7):
    """20k random triangles in [-1, 1]^3, sorted along a Morton curve so
    clusters are compact, with exact duplicates copied into far clusters
    (they pin the lowest-index tie rule); returns ([n, 9] triangles, tree
    args) on the card."""
    import numpy as np

    from akari_torch.bvh import cluster_tree as ct

    r = np.random.default_rng(seed)
    v0 = r.uniform(-1.0, 1.0, size=(n, 3))
    q = np.clip(((v0 + 1.0) * 512).astype(np.int64), 0, 1023)
    code = np.zeros(n, np.int64)
    for b in range(10):
        for a in range(3):
            code |= ((q[:, a] >> b) & 1) << (3 * b + a)
    v0 = v0[np.argsort(code, kind="stable")]
    e = r.normal(scale=0.06, size=(n, 6))
    tris = np.concatenate([v0, e], axis=1).astype(np.float32)
    tris[15000:15128] = tris[100:228]    # a whole cluster's worth, far away
    tris[4000:4040] = tris[19000:19040]  # duplicates of later triangles
    clusters = ct.build_clusters(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])
    nodes, span = ct.build_cluster_tree(clusters, n)
    store = ct.tree_tris(tris[:, 0:3], tris[:, 3:6], tris[:, 6:9])
    return (torch.from_numpy(tris).to(dev),
            (torch.from_numpy(nodes).to(dev), torch.from_numpy(store).to(dev), span))


def png_pixels(path):
    """[H, W, 3] uint8 from a PNG written by akari_torch.core.image
    (8-bit RGB, filter type 0 on every scanline)."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    check(not raw[:, 0].any(), "unexpected PNG filter type")
    return raw[:, 1:].reshape(h, w, 3)


def write_terrain_obj(directory, scene_node, res, spp, depth):
    """The terrain scene's meshes as OBJ + MTL and an .akari file that
    renders them; returns the .akari path."""
    import numpy as np

    terrain, light = scene_node.shapes
    obj = os.path.join(directory, "terrain.obj")
    with open(os.path.join(directory, "terrain.mtl"), "w") as f:
        f.write("newmtl ground\nKd 0.73 0.71 0.68\n"
                "newmtl light\nKd 0 0 0\nKe 14 13 11\n")
    nv = terrain.vertices.shape[0]
    with open(obj, "w") as f:
        f.write("mtllib terrain.mtl\n")
        np.savetxt(f, terrain.vertices, fmt="v %.9g %.9g %.9g")
        np.savetxt(f, light.vertices, fmt="v %.9g %.9g %.9g")
        f.write("usemtl ground\n")
        np.savetxt(f, terrain.indices + 1, fmt="f %d %d %d")
        f.write("usemtl light\n")
        np.savetxt(f, light.indices + 1 + nv, fmt="f %d %d %d")
    akari = os.path.join(directory, "terrain.akari")
    with open(akari, "w") as f:
        f.write(
            "export camera = PerspectiveCamera {\n"
            "    fov: 45, position: [0, 2.2, 2.2], rotation: [-40, 0, 0],\n"
            f"    resolution: [{res}, {res}]\n}}\n"
            'export mesh = AkariMesh { path: "terrain.obj" }\n'
            "export scene = Scene {\n"
            "    camera: $camera,\n"
            f"    integrator: Path {{ spp: {spp}, max_depth: {depth} }},\n"
            '    output: "terrain.png",\n'
            "    shapes: [ $mesh ]\n}\n"
        )
    return akari


def render_frame(render, scene, camera, cfg, torch):
    """One warm-up render, then one timed render: (image, ms by CUDA
    events, wall s, peak GiB)."""
    render(scene, camera, cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    t0 = time.perf_counter()
    ms = cuda_ms(lambda: out.append(render(scene, camera, cfg, seed=0)), iters=1, warmup=0)
    wall = time.perf_counter() - t0
    return out[0], ms, wall, torch.cuda.max_memory_allocated() / 2 ** 30


def frame_line(label, ms, wall, peak, res, cfg, card):
    paths = res * res * cfg.spp
    rays_total = paths * (2 * cfg.max_depth + 1)
    log(f"  {label}: {ms / 1e3:.4f} s/frame (CUDA events), {wall:.4f} s wall, "
        f"{paths / (ms / 1e3) / 1e6:.2f} Mpaths/s, "
        f"{rays_total / (ms / 1e3) / 1e6:.1f} M rays/s, peak {peak:.2f} GiB [card: {card}]")


def compile_timed(scene_node, dev, torch):
    """Compile on the host and move to the card; (scene, description of
    the host seconds: BVH build, clusters + tree, the rest, the copy)."""
    t0 = time.perf_counter()
    scene = scene_node.compile(intersector="auto")
    secs = scene.compile_seconds
    t1 = time.perf_counter()
    scene = scene.to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rest = secs["total"] - secs["bvh"] - secs["tree"]
    return scene, (
        f"host compile {t1 - t0:.2f} s (BVH build {secs['bvh']:.2f} s, clusters + tree "
        f"{secs['tree']:.2f} s, rest {rest:.2f} s, outside compile_scene "
        f"{t1 - t0 - secs['total']:.2f} s), copy to the card {t2 - t1:.2f} s"
    )


def check_image(img, res, label):
    import numpy as np

    check(img.shape == (res, res, 3), f"{label}: image shape {img.shape}")
    check(bool(np.all(np.isfinite(img))), f"{label}: non-finite radiance")
    mean = float(img.mean())
    log(f"  {label}: image mean {mean:.5f} (> {MEAN_LIT_MIN})")
    check(mean > MEAN_LIT_MIN, f"{label}: image too dark: mean {mean}")


def make_rays(scene, camera, n, seed, torch, box=((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95)),
              hit_t=None):
    """Primary rays, random rays with origins in ``box``, bounded t_max
    (half the ray's own hit distance from ``hit_t``, by default the dense
    plain version), dead rays (t_max = 0): an [8, n] pack."""
    from akari_torch.core.v3 import V3
    from akari_torch.integrators.path import camera_rays_soa
    from akari_torch.ops import dense_intersect as di

    if hit_t is None:
        hit_t = lambda r: di.closest_plain(r, scene.prim_table)[0]  # noqa: E731
    dev = scene.device
    n_prim = min(n // 4, camera.width * camera.height * 4)
    pix = torch.arange(n_prim, device=dev, dtype=torch.int64) % (camera.width * camera.height)
    smp = torch.div(torch.arange(n_prim, device=dev), camera.width * camera.height,
                    rounding_mode="floor")
    o1, d1 = camera_rays_soa(camera, seed, smp, pix)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = n - n_prim
    lo = torch.tensor(box[0], device=dev)
    hi = torch.tensor(box[1], device=dev)
    o2 = lo + (hi - lo) * torch.rand((m, 3), generator=g, device=dev)
    d2 = torch.randn((m, 3), generator=g, device=dev)
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    o = V3(*(torch.cat([a, o2[:, k]]) for k, a in enumerate(o1)))
    d = V3(*(torch.cat([a, d2[:, k]]) for k, a in enumerate(d1)))
    zero = torch.zeros(n, device=dev)
    tmax = torch.full((n,), di.T_MAX, device=dev)
    rays = di.pack_rays(o, d, zero, tmax).contiguous()
    t_hit = hit_t(rays)
    sel = torch.randint(0, 3, (n,), generator=g, device=dev)
    rays[7] = torch.where(sel == 0, t_hit * 0.5, torch.where(sel == 1, 0.0, tmax))
    return rays


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from akari_torch.cli import render as cli_render
    from akari_torch.core.v3 import V3
    from akari_torch.integrators import path as path_mod
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.kernels import build as kbuild
    from akari_torch.native import loader as native_loader
    from akari_torch.ops import dense_intersect as di
    from akari_torch.ops import tree_intersect as ti
    from akari_torch.ops.ray_sort import sort_keys_soa
    from akari_torch.scene.builtin import cornell_box, terrain_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- phase 1: setup -------------------------------------------------
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    log(f"phase 1: device {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
        native = pool.submit(native_loader.build)  # g++ beside the nvcc builds
        builds = {kname: pool.submit(kbuild.build, kname) for kname in KERNELS}
        libs = {kname: f.result() for kname, f in builds.items()}
        native_path = native.result()
    for kname in KERNELS:
        kbuild.load(kname)
    native_loader.load()
    build_s = time.perf_counter() - t0
    for kname, path in libs.items():
        log(f"  built {os.path.relpath(path, ROOT)}")
    log(f"  built {os.path.relpath(native_path, ROOT)} (g++, native BVH builder)")
    log(f"  all builds, in parallel: {build_s:.2f} s")
    for kname, (secs, report) in kbuild.BUILD_LOG.items():
        log(f"  nvcc {kname}: {secs:.2f} s; ptxas:\n    " + report.replace("\n", "\n    "))

    # ---- phase 2: kernel vs plain on the card ---------------------------
    log("phase 2: kernel vs plain PyTorch version on the card")
    sc = cornell_box(256, 256)
    scene = sc.compile(intersector="auto").to(dev)
    check(scene.intersector == "dense", f"intersector {scene.intersector}")
    rays = make_rays(scene, sc.camera, N_RAYS, 0, torch)
    err_box, occ_box, _ = compare_kernel(
        "cornell", rays, di, (scene.prim_table,), scene.n_tris)
    g = torch.Generator(device=dev).manual_seed(1)
    v0 = torch.rand((300, 3), generator=g, device=dev) * 2.0 - 1.0 + torch.tensor([0.0, 1.0, 0.0], device=dev)
    e1 = torch.randn((300, 3), generator=g, device=dev) * 0.3
    e2 = torch.randn((300, 3), generator=g, device=dev) * 0.3
    soup = torch.cat([v0, e1, e2], dim=1)
    soup[200:240] = soup[0:40]  # exact duplicates: ties go to the lower index
    soup = soup.contiguous()
    err_soup, occ_soup, _ = compare_kernel("soup", rays, di, (soup,), 300)
    max_abs_err = max(err_box, err_soup)
    occ_abs_err = max(occ_box, occ_soup)

    # ---- phase 3: the main path at the bench width ----------------------
    log("phase 3: render(cornell_box(256,256), spp=4, max_depth=5) on cuda")
    cfg = PathConfig(spp=4, max_depth=5)
    n_px = sc.camera.width * sc.camera.height
    chunk = max(1, min(cfg.spp, path_mod.MAX_RAYS_IN_FLIGHT // n_px))
    n_trace = (cfg.spp + chunk - 1) // chunk
    torch.cuda.synchronize()
    di.reset_launches()
    ti.reset_launches()
    img = render(scene, sc.camera, cfg, seed=0)
    torch.cuda.synchronize()
    launches = dict(di.LAUNCHES)
    expected = n_trace * (1 + cfg.max_depth)
    log(f"  launches {launches}, tree {ti.LAUNCHES}; expected closest = {n_trace} "
        f"trace_paths x (1 + {cfg.max_depth}) = {expected}")
    check(launches["closest"] == expected, f"launches {launches}, expected {expected}")
    check(sum(ti.LAUNCHES.values()) == 0, f"tree launches {ti.LAUNCHES} on the Cornell box")
    img_np = img.cpu().numpy()
    check(img_np.shape == (256, 256, 3), f"image shape {img_np.shape}")
    check(bool(np.all(np.isfinite(img_np))), "non-finite radiance")
    mean = float(img_np.mean())
    mid = img_np[128]
    log(f"  image mean {mean:.5f} (> {MEAN_LIT_MIN}); left wall {mid[8]}, right wall {mid[-9]}")
    check(mean > MEAN_LIT_MIN, f"image too dark: mean {mean}")
    check(mid[8][0] > mid[8][1] and mid[-9][1] > mid[-9][0], "walls not red/green")

    # ---- phase 4: cross-framework golden --------------------------------
    log("phase 4: 64x64 spp 4 depth 5 seed 0 vs the JAX package's golden")
    sc64 = cornell_box(64, 64)
    scene64 = sc64.compile(intersector="auto").to(dev)
    img64 = render(scene64, sc64.camera, PathConfig(spp=4, max_depth=5), seed=0)
    golden = np.load(GOLDEN)
    images_match(img64.cpu().numpy(), golden)

    # ---- phase 5: realistic size ----------------------------------------
    log(f"phase 5: 1024x1024, 16 spp, depth 5 [card: {card}]")
    sc1k = cornell_box(1024, 1024)
    scene1k = sc1k.compile(intersector="auto").to(dev)
    cfg1k = PathConfig(spp=16, max_depth=5)
    render(scene1k, sc1k.camera, cfg1k, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frame_ms = cuda_ms(lambda: render(scene1k, sc1k.camera, cfg1k, seed=0), iters=1, warmup=0)
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    paths = 1024 * 1024 * 16
    rays_total = paths * (2 * cfg1k.max_depth + 1)
    log(f"  render: {frame_ms / 1e3:.4f} s/frame (CUDA events), {wall_s:.4f} s wall, "
        f"{paths / (frame_ms / 1e3) / 1e6:.2f} Mpaths/s, "
        f"{rays_total / (frame_ms / 1e3) / 1e6:.1f} M rays/s, peak {peak_gb:.2f} GiB "
        f"[card: {card}]")
    with tempfile.TemporaryDirectory() as tmp:
        out_png = os.path.join(tmp, "out.png")
        argv = ["-i", SCENE_FILE, "-o", out_png, "--width", "1024", "--height", "1024",
                "--spp", "16", "--max-depth", "5", "--device", "cuda"]
        check(cli_render.main(argv) == 0, "CLI warm-up failed")
        rcs = []
        t0 = time.perf_counter()
        cli_ms = cuda_ms(lambda: rcs.append(cli_render.main(argv)), iters=1, warmup=0)
        cli_s = time.perf_counter() - t0
        check(rcs == [0], f"CLI returned {rcs}")
        with open(out_png, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n", "CLI output is not a PNG")
        w, h = int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")
        check((w, h) == (1024, 1024), f"CLI image {w}x{h}")
    log(f"  CLI (parse + compile + render + PNG): {cli_ms / 1e3:.4f} s (CUDA events), "
        f"{cli_s:.4f} s wall [card: {card}]")

    fused = rays[:, :FUSED_RAYS].contiguous()
    tris = scene.prim_table
    kernel_ms = cuda_ms(lambda: di.closest(fused, tris), iters=50)
    plain_ms = cuda_ms(lambda: di.closest_plain(fused, tris), iters=10)
    anyhit_ms = cuda_ms(lambda: di.any_hit(fused, tris), iters=50)
    anyhit_plain_ms = cuda_ms(lambda: di.any_hit_plain(fused, tris), iters=10)
    log(f"  closest at {FUSED_RAYS} rays x {tris.shape[0]} tris: kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms [card: {card}]")
    log(f"  any-hit at {FUSED_RAYS} rays: kernel {anyhit_ms:.4f} ms, "
        f"plain {anyhit_plain_ms:.4f} ms [card: {card}]")
    log(f"  phases 1-5: {time.perf_counter() - t_start:.1f} s")

    # ---- phase 6: tree kernel vs plain walk on the card -----------------
    t_phase = time.perf_counter()
    log("phase 6: tree kernel vs plain walk on the card")
    sc512 = terrain_scene(256, 256, n=512)
    scene512, compile512 = compile_timed(sc512, dev, torch)
    check(scene512.intersector == "tree", f"intersector {scene512.intersector}")
    check(scene512.n_tris == 522_244, f"n_tris {scene512.n_tris}")
    log(f"  terrain n=512: {scene512.n_tris} tris, {scene512.tri_tree.shape[0]} node rows, "
        f"leaf_span {scene512.tree_leaf_span}; {compile512}")
    targs = (scene512.tri_tree, scene512.tree_tris, scene512.tree_leaf_span)
    trays = make_rays(
        scene512, sc512.camera, TREE_RAYS, 2, torch,
        box=((-1.0, 0.0, -1.0), (1.0, 1.2, 1.0)),
        hit_t=lambda r: ti.closest_plain(r, *targs)[0],
    )
    err_terrain, occ_terrain, _ = compare_kernel(
        "tree terrain", trays, ti, targs, scene512.n_tris)
    soup_tris, sargs = tree_soup(dev, torch)
    srays = make_rays(
        SimpleNamespace(device=dev), sc512.camera, TREE_RAYS, 3, torch,
        box=((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
        hit_t=lambda r: ti.closest_plain(r, *sargs)[0],
    )
    err_tsoup, occ_tsoup, prim_soup = compare_kernel(
        "tree soup", srays, ti, sargs, soup_tris.shape[0])
    sub = srays[:, :SOUP_SUBSET].contiguous()
    dense_prim = di.closest_plain(sub, soup_tris)[3]
    check(torch.equal(dense_prim >= 0, ti.any_hit(sub, *sargs)),
          "tree any-hit != dense plain validity on the soup")
    check(torch.equal(dense_prim, prim_soup[:SOUP_SUBSET]),
          "tree prim != dense plain prim on the soup (tie rule)")
    log(f"  tree soup: on {SOUP_SUBSET} rays tree any-hit == tree closest validity == "
        "dense plain validity, and prims equal (lowest index wins ties)")
    tree_err = max(err_terrain, err_tsoup)
    tree_occ_err = max(occ_terrain, occ_tsoup)
    log(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 7: the large-scene main path ------------------------------
    t_phase = time.perf_counter()
    log("phase 7: render(terrain_scene(256,256,n=512), spp=4, max_depth=5) on auto")
    cfg = PathConfig(spp=4, max_depth=5)
    render(scene512, sc512.camera, cfg, seed=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    di.reset_launches()
    ti.reset_launches()
    out = []
    t0 = time.perf_counter()
    ms512 = cuda_ms(lambda: out.append(render(scene512, sc512.camera, cfg, seed=0)),
                    iters=1, warmup=0)
    wall512 = time.perf_counter() - t0
    tree_launches = dict(ti.LAUNCHES)
    dense_launches = dict(di.LAUNCHES)
    peak512 = torch.cuda.max_memory_allocated() / 2 ** 30
    expected = n_trace * (1 + cfg.max_depth)
    log(f"  launches: tree {tree_launches}, dense {dense_launches}; expected tree "
        f"closest = {n_trace} trace_paths x (1 + {cfg.max_depth}) = {expected}")
    check(tree_launches == {"closest": expected, "any_hit": 0},
          f"tree launches {tree_launches}, expected {expected}")
    check(dense_launches == {"closest": 0, "any_hit": 0}, f"dense launches {dense_launches}")
    check_image(out[0].cpu().numpy(), 256, "terrain n=512")
    frame_line("terrain n=512 256^2 spp 4 depth 5", ms512, wall512, peak512, 256, cfg, card)
    log(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 8: terrain golden -----------------------------------------
    log("phase 8: terrain n=64 64x64 spp 4 depth 5 seed 0 vs the JAX package's golden")
    sct = terrain_scene(64, 64, n=64)
    scene_t64 = sct.compile(intersector="auto").to(dev)
    check(scene_t64.intersector == "tree", f"intersector {scene_t64.intersector}")
    img_t64 = render(scene_t64, sct.camera, PathConfig(spp=4, max_depth=5), seed=0)
    images_match(img_t64.cpu().numpy(), np.load(TERRAIN_GOLDEN))

    # ---- phase 9: 2.09M triangles on auto --------------------------------
    t_phase = time.perf_counter()
    log("phase 9: render(terrain_scene(256,256,n=1024), spp=4, max_depth=5) on auto")
    sc1m = terrain_scene(256, 256, n=1024)
    scene1m, compile1m = compile_timed(sc1m, dev, torch)
    check(scene1m.intersector == "tree" and scene1m.n_tris == 2_093_060,
          f"{scene1m.intersector}, {scene1m.n_tris} tris")
    log(f"  terrain n=1024: {scene1m.n_tris} tris, {scene1m.tri_tree.shape[0]} node rows, "
        f"leaf_span {scene1m.tree_leaf_span}; {compile1m}")
    img1m, ms1m, wall1m, peak1m = render_frame(render, scene1m, sc1m.camera, cfg, torch)
    check_image(img1m.cpu().numpy(), 256, "terrain n=1024")
    frame_line("terrain n=1024 256^2 spp 4 depth 5", ms1m, wall1m, peak1m, 256, cfg, card)
    del scene1m, img1m
    torch.cuda.empty_cache()
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 10: the CLI on a large OBJ --------------------------------
    t_phase = time.perf_counter()
    log("phase 10: CLI render of the n=512 terrain as OBJ + MTL + .akari, 256x256 spp 4")
    with tempfile.TemporaryDirectory() as tmp:
        akari = write_terrain_obj(tmp, sc512, 256, 4, 5)
        out_png = os.path.join(tmp, "terrain.png")
        di.reset_launches()
        ti.reset_launches()
        t0 = time.perf_counter()
        rc = cli_render.main(["-i", akari, "-o", out_png, "--device", "cuda", "-v"])
        cli_obj_s = time.perf_counter() - t0
        check(rc == 0, f"CLI returned {rc}")
        check(ti.LAUNCHES["closest"] > 0 and sum(di.LAUNCHES.values()) == 0,
              f"CLI launches: tree {ti.LAUNCHES}, dense {di.LAUNCHES}")
        px = png_pixels(out_png)
    check(px.shape == (256, 256, 3), f"CLI image {px.shape}")
    log(f"  CLI (parse OBJ + compile + render + PNG): {cli_obj_s:.3f} s wall, "
        f"PNG mean {px.mean():.1f}/255, tree launches {ti.LAUNCHES['closest']}")
    check(px.mean() > 20, f"CLI image too dark: {px.mean()}")
    log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")

    # ---- phase 11: tree kernel and plain walk times ----------------------
    t_phase = time.perf_counter()
    log(f"phase 11: tree kernel vs plain walk at the fused shape [card: {card}]")
    captured = []
    closest = ti.closest

    def capture(rays_, *args_):  # keeps the first fused launch's rays
        if not captured and rays_.shape[1] == FUSED_RAYS:
            captured.append(rays_.clone())
        return closest(rays_, *args_)

    ti.closest = capture
    try:
        render(scene512, sc512.camera, cfg, seed=0)
    finally:
        ti.closest = closest
    check(len(captured) == 1, "no fused launch of the expected shape was seen")
    rays_u = captured[0]  # what the main path launches on
    k = (scene512.n_tris + 127) // 128
    key = sort_keys_soa(
        V3(*rays_u[0:3]), V3(*rays_u[3:6]),
        scene512.tri_clusters[:k, 0:3].min(0).values,
        scene512.tri_clusters[:k, 3:6].max(0).values, rays_u[6], rays_u[7],
        hint="secondary",
    )
    rays_s = rays_u[:, torch.argsort(key, stable=True)].contiguous()
    times = {}
    times["kernel_unsorted"] = cuda_ms(lambda: ti.closest(rays_u, *targs), iters=20)
    times["kernel_sorted"] = cuda_ms(lambda: ti.closest(rays_s, *targs), iters=20)
    times["any_hit_unsorted"] = cuda_ms(lambda: ti.any_hit(rays_u, *targs), iters=20)
    times["any_hit_sorted"] = cuda_ms(lambda: ti.any_hit(rays_s, *targs), iters=20)
    times["plain_unsorted"] = cuda_ms(lambda: ti.closest_plain(rays_u, *targs), iters=1, warmup=1)
    times["plain_sorted"] = cuda_ms(lambda: ti.closest_plain(rays_s, *targs), iters=1, warmup=0)
    times["any_hit_plain_unsorted"] = cuda_ms(lambda: ti.any_hit_plain(rays_u, *targs),
                                              iters=1, warmup=0)
    n_dead = int((rays_u[7] <= rays_u[6]).sum())
    log(f"  fused launch: {FUSED_RAYS} rays ({n_dead} dead) x {scene512.n_tris} tris; "
        f"ms per call (CUDA events) [card: {card}]:")
    for name_, ms_ in times.items():
        log(f"    {name_}: {ms_:.4f} ms")
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # ---- phase 12: result ------------------------------------------------
    record = {
        "kernels": [
            {
                "name": "dense_closest",
                "route": "cuda",
                "source": "akari_torch/kernels/csrc/dense_intersect.cu",
                "replaces": "akari_tpu/ops/pallas_intersect.py:141",
                "launches": launches["closest"],
                "max_abs_err": max_abs_err,
                "ms": kernel_ms,
                "plain_ms": plain_ms,
            },
            {
                "name": "tree_closest",
                "route": "cuda",
                "source": "akari_torch/kernels/csrc/tree_intersect.cu",
                "replaces": "akari_tpu/ops/pallas_tree.py:194",
                "launches": tree_launches["closest"],
                "max_abs_err": tree_err,
                "ms": times["kernel_unsorted"],
                "plain_ms": times["plain_unsorted"],
            },
        ],
        # ported with the same launcher, not on the fused main path
        "off_path_kernels": [
            {
                "name": "dense_any_hit",
                "route": "cuda",
                "source": "akari_torch/kernels/csrc/dense_intersect.cu",
                "replaces": "akari_tpu/ops/pallas_intersect.py:153",
                "launches": launches["any_hit"],
                "max_abs_err": occ_abs_err,
                "ms": anyhit_ms,
                "plain_ms": anyhit_plain_ms,
            },
            {
                "name": "tree_any_hit",
                "route": "cuda",
                "source": "akari_torch/kernels/csrc/tree_intersect.cu",
                "replaces": "akari_tpu/ops/pallas_tree.py:194",
                "launches": tree_launches["any_hit"],
                "max_abs_err": tree_occ_err,
                "ms": times["any_hit_unsorted"],
                "plain_ms": times["any_hit_plain_unsorted"],
            },
        ],
    }
    print(json.dumps(record), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
