"""Progressive (chunked) rendering with progress reporting and
checkpoint / resume (``akari_tpu/integrators/progressive.py``).

The bounded resource is samples in flight: each pass renders the whole
frame for a chunk of spp, and the chunks accumulate into a host-side
float32 film. Long renders survive preemption through
``utils/checkpoint.py``, whose files either package resumes. With a ray
mesh each chunk renders ray-sharded (``parallel/render.py``), every rank
holds the reduced accumulator, and rank 0 alone writes the checkpoints.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.film import Film
from ..parallel.render import render_sharded
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
    With ``mesh`` (a ``RayMesh``; every rank calls this) each chunk renders
    through ``render_sharded``; rank 0 writes each checkpoint and the
    ranks meet at a barrier after it, and every rank reads the file to
    resume. Only rank 0 reports progress.
    """
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

    lead = mesh is None or mesh.rank == 0
    reporter = ProgressReporter(total, label="render") if progress and lead else None
    if reporter and start_sample:
        reporter.update(start_sample)

    done = start_sample
    while done < total:
        n = min(spp_chunk, total - done)
        chunk_cfg = dataclasses.replace(cfg, spp=n)
        if mesh is not None:
            img = render_sharded(scene, camera, chunk_cfg, mesh, seed=seed, sample_offset=done)
        else:
            img = render(scene, camera, chunk_cfg, seed=seed, sample_offset=done)
        acc = acc + img.cpu().numpy() * n
        done += n
        if reporter:
            reporter.update(n)
        if checkpoint_path and (
            done % (checkpoint_every * spp_chunk) == 0 or done >= total
        ):
            if lead:
                save_render_state(checkpoint_path, acc, done, seed, meta)
            if mesh is not None:  # no rank runs ahead of the file
                mesh.barrier()

    film = Film(radiance=acc, weight=np.full((camera.height, camera.width), total, np.float32))
    return film.develop()
