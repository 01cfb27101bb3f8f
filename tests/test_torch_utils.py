"""Port parity: film, progress, logger, profiler and train-state
checkpoints (``akari_torch/core/film.py``, ``akari_torch/utils/``)
against akari_tpu's. Film arithmetic is equal bit for bit on NumPy
arrays and on tensors, except a tensor's sum over the sample axis, which
adds in torch's order (rtol 1e-6); the progress bar's text, the logger's prefix and
the profiler's table are the reference's character for character. The
train-state format is the port's own (``torch.save``; the JAX package
pickles optax state or writes orbax directories: ROADMAP Queue 3).
"""

import io
import json
import logging
import os
import re

import numpy as np
import pytest
import torch

from akari_torch.core.film import Film, accumulate_samples
from akari_torch.utils import checkpoint, logger, profiler, progress
from akari_tpu.core import film as ref_film
from akari_tpu.utils import logger as ref_logger
from akari_tpu.utils import profiler as ref_profiler
from akari_tpu.utils import progress as ref_progress

torch.set_num_threads(2)


def _samples(seed=0):
    return np.random.default_rng(seed).random((5, 4, 6, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_film_and_accumulate_samples_match_reference(kind):
    s = _samples()
    conv = (lambda a: a) if kind == "numpy" else torch.from_numpy
    back = (lambda a: a) if kind == "numpy" else (lambda t: t.numpy())
    rad, w = accumulate_samples(conv(s))
    rad_r, w_r = ref_film.accumulate_samples(s)
    if kind == "numpy":
        np.testing.assert_array_equal(rad, rad_r)
    else:  # torch's sum over the sample axis adds in its own order
        np.testing.assert_allclose(back(rad), rad_r, rtol=1e-6)
        rad = torch.from_numpy(rad_r)
    np.testing.assert_array_equal(back(w), w_r)
    assert back(w).dtype == np.float32
    xp = np if kind == "numpy" else torch
    film = Film.zeros(4, 6, xp=xp, device="cpu").add(rad, w)
    film_r = ref_film.Film.zeros(4, 6).add(rad_r, w_r)
    film = film.add(conv(s[0]), conv(np.ones((4, 6), np.float32)))
    film_r = film_r.add(s[0], np.ones((4, 6), np.float32))
    np.testing.assert_array_equal(back(film.develop()), film_r.develop())
    np.testing.assert_array_equal(film.to_srgb_u8(), film_r.to_srgb_u8())
    # a pixel with no weight develops to its radiance (weight taken as 1)
    empty = Film(radiance=conv(s[0]), weight=conv(np.zeros((4, 6), np.float32)))
    np.testing.assert_array_equal(back(empty.develop()), s[0])


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("steps", [[1] * 10, [3, 5, 2], [10]])
def test_progress_text_matches_reference(monkeypatch, steps):
    outs = []
    for mod in (progress, ref_progress):
        clock = _Clock()
        monkeypatch.setattr(mod.time, "monotonic", clock)
        buf = io.StringIO()
        rep = mod.ProgressReporter(10, label="render", stream=buf)
        for n in steps:
            clock.t += 0.25
            rep.update(n)
        outs.append(buf.getvalue())
        monkeypatch.undo()
    assert outs[0] == outs[1]
    assert outs[0].count("\r") == len(steps)
    assert outs[0].endswith(f"100.0% ({0.25 * len(steps):6.1f}s, eta    0.0s)\n")


def test_progress_rate_limit_and_eta():
    clock = _Clock()
    buf = io.StringIO()
    import unittest.mock as um

    with um.patch.object(progress.time, "monotonic", clock):
        rep = progress.ProgressReporter(4, stream=buf, width=8)
        clock.t += 1.0
        rep.update()
        clock.t += 0.05
        rep.update()  # inside 0.1 s of the last draw: skipped
        clock.t += 0.05
        rep.update(2)  # the last update always draws
    lines = buf.getvalue().split("\r")[1:]
    assert lines[0] == "render [==      ]  25.0% (   1.0s, eta    3.0s)"
    assert len(lines) == 2 and lines[1].startswith("render [========] 100.0%")


def test_logger_format_and_levels(monkeypatch):
    monkeypatch.setattr(logger.time, "monotonic", lambda: logger._START + 12.3456)
    rec = logging.LogRecord("akari_torch", logger.VERBOSE, __file__, 1, "hello %s", ("x",),
                            None)
    assert logger._ElapsedFormatter().format(rec) == "[   12.346s VERBOSE] hello x"
    monkeypatch.setattr(ref_logger.time, "monotonic", lambda: ref_logger._START + 12.3456)
    assert ref_logger._ElapsedFormatter().format(rec) == "[   12.346s VERBOSE] hello x"
    assert logger.VERBOSE == ref_logger.VERBOSE == 15
    log = logger.get_logger()
    assert log is logger.get_logger() and log.name == "akari_torch"
    assert log is not ref_logger.get_logger()
    logger.set_verbose(True)
    assert log.level == logging.DEBUG
    logger.set_verbose(False)
    assert log.level == logging.INFO
    buf = io.StringIO()
    h = logging.StreamHandler(buf)
    logger.add_handler(h)
    try:
        log.info("observed")
    finally:
        log.removeHandler(h)
    assert buf.getvalue() == "observed\n"


def _fill(prof):
    prof.stats["render/path"] = [2, 0.5, 0.2, 0.3]
    prof.stats["write_image"] = [1, 0.01, 0.01, 0.01]
    prof.stats["a-very-long-span-name-beyond-32-chars"] = [3, 0.75, 0.125, 0.5]


def test_profiler_table_matches_reference():
    mine, theirs = profiler.Profiler(), ref_profiler.Profiler()
    _fill(mine)
    _fill(theirs)
    a, b = io.StringIO(), io.StringIO()
    mine.print_stats(a)
    theirs.print_stats(b)
    assert a.getvalue() == b.getvalue()
    rows = a.getvalue().splitlines()
    assert rows[0].split() == ["span", "calls", "total(ms)", "min(ms)", "max(ms)", "avg(ms)"]
    assert rows[1].startswith("a-very-long-span") and rows[3].startswith("write_image")


def test_profiler_frame_times_spans():
    prof = profiler.Profiler()
    for _ in range(3):
        with prof.frame("work"):
            torch.ones(1000).sum()
    n, total, mn, mx = prof.stats["work"]
    assert n == 3 and 0.0 < mn <= total / 3 <= mx and total < 5.0
    with pytest.raises(RuntimeError):
        with prof.frame("failing"):
            raise RuntimeError("the span's body raised")
    assert "failing" not in prof.stats


def test_kernel_timer_on_the_cpu():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return torch.cumsum(x * scale, 0)

    s = profiler.kernel_timer(fn, torch.ones(10_000), warmup=2, iters=4, scale=2.0)
    assert len(calls) == 6 and 0.0 < s < 1.0
    s0 = profiler.kernel_timer(fn, torch.ones(10), warmup=0, iters=1)
    assert len(calls) == 8 and s0 > 0.0  # one call at least tells the device


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "tr")) as prof:
        with torch.profiler.record_function("span-in-trace"):
            torch.ones(100).sum()
    assert prof is not None
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "span-in-trace" for e in events)


def test_train_state_round_trip(tmp_path):
    params = {"tex_value": torch.rand(4, 3, requires_grad=True)}
    opt = torch.optim.Adam(list(params.values()), lr=0.05)
    params["tex_value"].sum().backward()
    opt.step()
    p = str(tmp_path / "sub" / "train.pt")
    checkpoint.save_train_state(p, {k: v.detach() for k, v in params.items()},
                                opt.state_dict(), step=17, seed=3)
    assert os.listdir(tmp_path / "sub") == ["train.pt"]  # no temporary left
    st = checkpoint.load_train_state(p)
    assert (st["step"], st["seed"]) == (17, 3)
    assert torch.equal(st["params"]["tex_value"], params["tex_value"].detach())
    opt2 = torch.optim.Adam([torch.zeros(4, 3, requires_grad=True)], lr=0.05)
    opt2.load_state_dict(st["opt_state"])
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"],
                       opt.state_dict()["state"][0]["exp_avg"])
    assert checkpoint.load_train_state(str(tmp_path / "missing.pt")) is None


def test_cli_profile_prints_spans_and_stamped_lines(tmp_path, capfd):
    from akari_torch.cli.render import main

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scene = os.path.join(root, "scenes", "cornell_box", "scene.akari")
    stream = logger.get_logger().handlers[0]
    buf = io.StringIO()
    old, stream.stream = stream.stream, buf
    table = io.StringIO()
    import unittest.mock as um

    try:
        with um.patch.object(profiler.sys, "stderr", table):
            assert main(["-i", scene, "-o", str(tmp_path / "p.png"), "--device", "cpu",
                         "--width", "8", "--height", "8", "--spp", "1", "--profile", "-v"]) == 0
    finally:
        stream.stream = old
        logger.set_verbose(False)
    assert re.search(r"^\[ *\d+\.\d{3}s INFO\] wrote ", buf.getvalue(), re.M)
    rows = table.getvalue().splitlines()
    assert rows[0].startswith("span") and {r.split()[0] for r in rows[1:]} == {
        "render/path", "write_image"}
