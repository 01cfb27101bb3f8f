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
6. the result: a JSON line of kernel records, then the device line.

Imports nothing of JAX. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_cornell64_spp4_d5.npy")
SCENE_FILE = os.path.join(ROOT, "scenes", "cornell_box", "scene.akari")

N_RAYS = (1 << 20) + 77          # not a multiple of any block size
FUSED_RAYS = 2 * 256 * 256 * 4   # shadow + extension rays of one bounce
MEAN_LIT_MIN = 0.05              # "clearly lit" bound on the mean radiance


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


def compare_kernel(name, rays, tris, di):
    """Kernel vs plain on the card; returns the max |difference| of the
    closest-hit outputs and of the any-hit flags."""
    import torch

    t_k, u_k, v_k, p_k = di.closest(rays, tris)
    t_p, u_p, v_p, p_p = di.closest_plain(rays, tris)
    torch.cuda.synchronize()
    check(torch.equal(p_k, p_p), f"{name}: prim differs on {int((p_k != p_p).sum())} rays")
    valid = p_k >= 0
    n_valid = int(valid.sum())
    errs, ulps = [], []
    for a, b in ((t_k, t_p), (u_k, u_p), (v_k, v_p)):
        errs.append(float((a - b).abs().max()))
        ulps.append(ulp_diff(a[valid], b[valid]))
    max_err, max_ulp = max(errs), max(ulps)
    check(max_ulp <= 2, f"{name}: t/u/v differ by {max_ulp} ulp")
    occ_k = di.any_hit(rays, tris)
    occ_p = di.any_hit_plain(rays, tris)
    torch.cuda.synchronize()
    check(torch.equal(occ_k, occ_p), f"{name}: any-hit kernel != plain")
    check(torch.equal(occ_k, valid), f"{name}: any-hit != closest.valid")
    occ_err = float((occ_k.float() - occ_p.float()).abs().max())
    log(f"  {name}: {rays.shape[1]} rays x {tris.shape[0]} tris, {n_valid} hits, "
        f"prim/valid exact, t/u/v max |diff| {max_err:.3g} ({max_ulp} ulp), "
        f"any-hit == closest.valid == plain")
    return max_err, occ_err


def make_rays(scene, camera, n, seed, torch):
    """Primary rays, random rays inside the box, bounded t_max (half the
    ray's own hit distance), dead rays (t_max = 0): an [8, n] pack."""
    from akari_torch.core.v3 import V3
    from akari_torch.integrators.path import camera_rays_soa
    from akari_torch.ops import dense_intersect as di

    dev = scene.device
    n_prim = min(n // 4, camera.width * camera.height * 4)
    pix = torch.arange(n_prim, device=dev, dtype=torch.int64) % (camera.width * camera.height)
    smp = torch.div(torch.arange(n_prim, device=dev), camera.width * camera.height,
                    rounding_mode="floor")
    o1, d1 = camera_rays_soa(camera, seed, smp, pix)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = n - n_prim
    lo = torch.tensor([-0.95, 0.05, -0.95], device=dev)
    hi = torch.tensor([0.95, 1.95, 0.95], device=dev)
    o2 = lo + (hi - lo) * torch.rand((m, 3), generator=g, device=dev)
    d2 = torch.randn((m, 3), generator=g, device=dev)
    d2 = d2 / d2.norm(dim=1, keepdim=True)
    o = V3(*(torch.cat([a, o2[:, k]]) for k, a in enumerate(o1)))
    d = V3(*(torch.cat([a, d2[:, k]]) for k, a in enumerate(d1)))
    zero = torch.zeros(n, device=dev)
    tmax = torch.full((n,), di.T_MAX, device=dev)
    rays = di.pack_rays(o, d, zero, tmax).contiguous()
    t_hit = di.closest_plain(rays, scene.prim_table)[0]
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
    from akari_torch.integrators import path as path_mod
    from akari_torch.integrators.path import PathConfig, render
    from akari_torch.kernels import build as kbuild
    from akari_torch.ops import dense_intersect as di
    from akari_torch.scene.builtin import cornell_box

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # ---- phase 1: setup -------------------------------------------------
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(card)
    log(f"phase 1: device {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = kbuild.build("dense_intersect")
    kbuild.load("dense_intersect")
    build_s = time.perf_counter() - t0
    log(f"  built {os.path.relpath(lib_path, ROOT)} in {build_s:.2f} s")
    for kname, (secs, report) in kbuild.BUILD_LOG.items():
        log(f"  nvcc {kname}: {secs:.2f} s; ptxas:\n    " + report.replace("\n", "\n    "))

    # ---- phase 2: kernel vs plain on the card ---------------------------
    log("phase 2: kernel vs plain PyTorch version on the card")
    sc = cornell_box(256, 256)
    scene = sc.compile(intersector="auto").to(dev)
    check(scene.intersector == "dense", f"intersector {scene.intersector}")
    rays = make_rays(scene, sc.camera, N_RAYS, 0, torch)
    err_box, occ_box = compare_kernel("cornell", rays, scene.prim_table, di)
    g = torch.Generator(device=dev).manual_seed(1)
    v0 = torch.rand((300, 3), generator=g, device=dev) * 2.0 - 1.0 + torch.tensor([0.0, 1.0, 0.0], device=dev)
    e1 = torch.randn((300, 3), generator=g, device=dev) * 0.3
    e2 = torch.randn((300, 3), generator=g, device=dev) * 0.3
    soup = torch.cat([v0, e1, e2], dim=1)
    soup[200:240] = soup[0:40]  # exact duplicates: ties go to the lower index
    soup = soup.contiguous()
    err_soup, occ_soup = compare_kernel("soup", rays, soup, di)
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
    img = render(scene, sc.camera, cfg, seed=0)
    torch.cuda.synchronize()
    launches = dict(di.LAUNCHES)
    expected = n_trace * (1 + cfg.max_depth)
    log(f"  launches {launches}; expected closest = {n_trace} trace_paths x "
        f"(1 + {cfg.max_depth}) = {expected}")
    check(launches["closest"] == expected, f"launches {launches}, expected {expected}")
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
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # ---- phase 6: result -------------------------------------------------
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
