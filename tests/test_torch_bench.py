"""The port's benchmark (bench_torch.py) and step profiler
(tools/profile_step_torch.py) on the CPU, at small sizes (the module
constants patched, as tests/test_torch_sharded.py patches
bench_scaling_torch.RES).

- The bench step at 64x64 against the JAX package's loss and texel
  gradient (tests/data/torch_port_grad_cornell64_spp4_d5.npz): loss rtol
  1e-6, gradient within 1e-5 * max|g|, as
  tests/test_torch_diff.py::test_gradient_golden_matches_the_plain_route.
- The last line holds exactly bench.py's four keys; with a stubbed timer
  ``value`` follows rays = spp * W * H * (2 * depth + 1) over the median.
- ``--device cuda`` without a card exits non-zero and prints no result.
- ``--full`` with every size shrunk writes the notes: each of bench.py's
  sections in order, every stage row, no TPU figure.
- The step profiler prints every row, the profiled step's line and its
  JSON line.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from _port_diff import assert_rel_close

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_grad_cornell64_spp4_d5.npz")
CPU = torch.device("cpu")
KEYS = ["metric", "value", "unit", "vs_baseline"]
SECTIONS = [
    "## Canonical workload",
    "## Large mesh: terrain",
    "## Per-stage timing",
    "-triangle terrain, default (`auto`) route",
    "## Instanced two-level scene",
    "## Spectrum dtype variant",
    "## Fwd+bwd step attribution",
    "## Where the time goes",
    "## Primary metric",
]
STAGES = ["| camera_rays ", "| intersect closest ", "(dense kernel, 36 tris)",
          "| occlude ", "(tree kernel, ", "| full forward render "]
PROFILE_ROWS = [
    "step fwd+bwd (bench metric)", "loss fwd only (sharded)", "render fwd (no mesh or loss)",
    "camera + 6 intersect launches (1x n + 5x 2n)", "camera_rays only",
    "single intersect launch (n rays)", "single intersect launch (2n rays)",
    "gather_rows_t prim_table [n]", "render fwd depth-1 (camera + 1 bounce + 2 intersect)",
    "step fwd+bwd depth-1 (no mesh)", "step fwd+bwd (no mesh)",
]


def test_bench_step_matches_the_grad_golden():
    gold = np.load(GOLDEN)
    assert gold["config"].tolist() == [64, 64, bench_torch.SPP, bench_torch.DEPTH, 0]
    scene, camera, cfg, mesh, target = bench_torch.bench_setup(CPU, res=64)
    assert scene.intersector == "dense" and mesh.size == 1 and not cfg.remat
    loss, g = bench_torch.bench_step(scene, camera, cfg, mesh, target)
    np.testing.assert_allclose(float(loss), float(gold["loss"]), rtol=1e-6)
    assert_rel_close(g.numpy(), gold["grad_tex_value"], 1e-5)


def _stub_timer(monkeypatch, times):
    calls = []

    def fake(fn, iters, warmup, device):
        calls.append((iters, warmup, device.type))
        fn()
        return list(times)

    monkeypatch.setattr(bench_torch, "step_times", fake)
    return calls


def test_primary_prints_the_four_keys_last(monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "RES", 16)
    calls = _stub_timer(monkeypatch, [40.0, 20.0, 30.0, 50.0, 10.0, 25.0, 35.0, 45.0, 15.0, 60.0])
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert list(last) == KEYS
    assert last["metric"] == "rays_per_sec_per_chip_fwd_bwd_4spp_cornell"
    assert last["unit"] == "rays/s/chip"
    rays = 4 * 16 * 16 * (2 * 5 + 1)
    value = rays / (32.5 / 1e3)  # the median of the stubbed times, one rank
    assert last["value"] == round(value, 1)
    assert last["vs_baseline"] == round(value / 0.5e6, 3)
    timing = json.loads(lines[-2])
    assert timing["median_ms"] == 32.5 and timing["min_ms"] == 10.0 and timing["max_ms"] == 60.0
    assert (timing["q1_ms"], timing["q3_ms"]) == (21.25, 43.75)
    assert timing["n"] == 10 and timing["rays_per_step"] == rays and timing["card"] == "cpu"
    assert np.isfinite(timing["loss"]) and timing["loss"] > 0
    assert calls == [(bench_torch.ITERS, bench_torch.WARMUP, "cpu")]
    assert bench_torch.ITERS >= 10 and bench_torch.WARMUP == 2


def test_primary_spawns_one_rank_a_card(monkeypatch):
    """With more than one card seen and no WORLD_SIZE, the primary metric
    runs in one spawned rank a card (bench.py's make_ray_mesh() spans every
    local device) and reports rank 0's run; rank 0 runs here on the CPU."""
    from akari_torch.parallel import launch
    from akari_torch.parallel.mesh import make_ray_mesh

    monkeypatch.setattr(bench_torch, "RES", 16)
    _stub_timer(monkeypatch, [20.0] * 10)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    asked = []

    def fake_spawn(fn, world_size, args=(), **kw):
        asked.append((world_size, kw["device"]))
        return [fn(make_ray_mesh("cpu"), *args) for _ in range(world_size)]

    monkeypatch.setattr(launch, "spawn_ranks", fake_spawn)
    run = bench_torch.primary("cuda")
    assert asked == [(2, "cuda")]
    assert isinstance(run.loss, torch.Tensor) and isinstance(run.grad, torch.Tensor)
    want = bench_torch.primary("cpu")
    np.testing.assert_array_equal(run.grad.numpy(), want.grad.numpy())
    assert float(run.loss) == float(want.loss) and run.result == want.result


def test_step_times_calls_after_the_warm_ups():
    calls = []
    times = bench_torch.step_times(lambda: calls.append(1), 4, 2, CPU)
    assert len(times) == 4 and len(calls) == 6 and all(t >= 0 for t in times)
    s = bench_torch.summary([3.0, 1.0, 2.0, 4.0])
    assert s == {"median_ms": 2.5, "q1_ms": 1.75, "q3_ms": 3.25, "min_ms": 1.0,
                 "max_ms": 4.0, "n": 4}


@pytest.mark.parametrize("script", ["bench_torch.py", "tools/profile_step_torch.py"])
def test_no_card_exits_nonzero_without_a_result(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, on any machine
    out = subprocess.run([sys.executable, script], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_full_suite_writes_the_notes(monkeypatch, tmp_path, capsys):
    for name, value in dict(RES=16, CANON_RES=16, CANON_SPP=2, FRAME_RES=8, TERRAIN_N=48,
                            BIG_TERRAIN_N=48, INSTANCES=2, INSTANCE_N=8, FRAME_ITERS=1,
                            VARIANT_ROUNDS=2, ITERS=1, WARMUP=0).items():
        monkeypatch.setattr(bench_torch, name, value)
    notes = tmp_path / "notes.md"
    monkeypatch.setitem(bench_torch.NOTES, "cpu", str(notes))
    assert bench_torch.main(["--device", "cpu", "--full"]) == 0
    text = notes.read_text()
    at = [text.index(s) for s in SECTIONS]
    assert at == sorted(at)
    stage_table = text[text.index("## Per-stage timing"):text.index("-triangle terrain")]
    for row in STAGES:
        assert row in stage_table, row
    assert "intersector resolved: `tree`" in text  # 4,434 triangles: the tree route on auto
    assert "two-level (instanced tree walk" in text
    assert text.count("| rgb-float32 |") == 2 and text.count("| rgb-bfloat16 |") == 2
    assert "one dense intersect launch (1,024 rays)" in text
    for word in ("TPU", "v5e", "XLA", "pallas"):
        assert word not in text, word
    assert text.count("[card: cpu]") >= 7
    assert list(json.loads(capsys.readouterr().out.strip().splitlines()[-1])) == KEYS


def test_profile_step_prints_every_row(monkeypatch, capsys):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import profile_step_torch

    monkeypatch.setattr(bench_torch, "RES", 16)
    monkeypatch.setattr(bench_torch, "WARMUP", 0)
    assert profile_step_torch.main(["--device", "cpu", "--iters", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rows = json.loads(out[-1])
    assert list(rows) == PROFILE_ROWS
    assert all(v >= 0 for v in rows.values())
    table = [line for line in out if line.startswith("| ")]
    assert [line.split(" | ")[0][2:] for line in table[1:]] == PROFILE_ROWS
    prof = json.loads(next(line for line in out if line.startswith('{"profiled_step"')))
    assert prof["device_idle_share"] == "not measured"  # no device on the CPU
    assert prof["kernel_launches"] == "not measured" and prof["wall_ms_profiled"] > 0
