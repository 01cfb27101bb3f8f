"""Progressive (chunked) rendering with progress reporting and
checkpoint / resume (``akari_tpu/integrators/progressive.py``).

The bounded resource is samples in flight: each pass renders the whole
frame for a chunk of spp, and the chunks accumulate into a host-side
float32 film. Long renders survive preemption through
``utils/checkpoint.py``, whose files either package resumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.film import Film
from ..utils.checkpoint import load_render_state, save_render_state
from ..utils.progress import ProgressReporter
from .path import PathConfig, render


def render_progressive(
    scene,
    camera,
    cfg: PathConfig,
    seed=0,
    spp_chunk=4,
    checkpoint_path=None,
    checkpoint_every=4,
    progress=True,
    mesh=None,
):
    """Render cfg.spp samples in chunks; returns the developed [H, W, 3]
    float32 NumPy image.

    Chunk k renders samples [done, done + n) of the one sample stream
    (``render(..., sample_offset=done)``) and adds ``img * n`` to the
    accumulator. With ``checkpoint_path`` the accumulator is saved every
    ``checkpoint_every`` chunks and at the end, and a saved state resumes
    when its ``meta`` (size, spp, depth) and seed match this call's.
    ``mesh`` (a device mesh for ray-sharded chunks) arrives with slice 6.
    """
    if mesh is not None:
        raise NotImplementedError("ray-sharded progressive renders arrive with slice 6")
    total = cfg.spp
    start_sample = 0
    acc = np.zeros((camera.height, camera.width, 3), np.float32)
    meta = {
        "w": camera.width, "h": camera.height,
        "spp": cfg.spp, "max_depth": cfg.max_depth,
    }
    if checkpoint_path:
        state = load_render_state(checkpoint_path)
        if state is not None and state[3] == meta and state[2] == seed:
            acc, start_sample = np.asarray(state[0]), state[1]

    reporter = ProgressReporter(total, label="render") if progress else None
    if reporter and start_sample:
        reporter.update(start_sample)

    done = start_sample
    while done < total:
        n = min(spp_chunk, total - done)
        chunk_cfg = dataclasses.replace(cfg, spp=n)
        img = render(scene, camera, chunk_cfg, seed=seed, sample_offset=done)
        acc = acc + img.cpu().numpy() * n
        done += n
        if reporter:
            reporter.update(n)
        if checkpoint_path and (
            done % (checkpoint_every * spp_chunk) == 0 or done >= total
        ):
            save_render_state(checkpoint_path, acc, done, seed, meta)

    film = Film(radiance=acc, weight=np.full((camera.height, camera.width), total, np.float32))
    return film.develop()
