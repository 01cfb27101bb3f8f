"""Write the instanced golden image the PyTorch port's two-level route is checked against.

Builds the instanced forest with the JAX package's (``akari_tpu``) node
types: 8 copies of ``terrain_mesh(n=16)``, instance k at
``translate(U(-6, 6), 0, U(-6, 6)) @ rotate_y(U(0, 2 pi)) @ scale(s, s, s)``
with ``s = U(0.5, 1.5)``, drawn in that order from
``np.random.default_rng(3)``, under a downward 4 x 4 emissive quad at
y = 4, seen from ``look_at((6, 5, 9), (0, 0.3, 0))`` at 40 degrees. It
forces the two-level compile with ``FLATTEN_MAX_TRIS = 1`` (as ``bench.py``
does), renders 64 x 64 at 4 spp, depth 5, seed 0 on the CPU through the
XLA two-level traversal, and saves the float32 [64, 64, 3] linear image
as ``tests/data/torch_port_instanced64_spp4_d5.npy``. The port builds the
same scene with ``akari_torch.scene.builtin.instanced_forest_scene``;
``chip_smoke.py`` and ``tests/test_torch_instancing.py`` compare its
render with this image under the outlier budget of ``tests/_imgcmp.py``.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_instanced_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_instanced64_spp4_d5.npy")
WIDTH = HEIGHT = 64
N_INSTANCES, TERRAIN_N = 8, 16
SPP, MAX_DEPTH, SEED = 4, 5, 0


def forest_transforms(n_instances, spread=6.0, seed=3):
    """Object -> world [4, 4] float32 transforms of the forest's instances."""
    import numpy as np

    from akari_tpu.core import transform as xform

    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_instances):
        tx, tz = float(r.uniform(-spread, spread)), float(r.uniform(-spread, spread))
        theta = float(r.uniform(0.0, 2.0 * np.pi))
        s = float(r.uniform(0.5, 1.5))
        m = xform.translate((tx, 0.0, tz)) @ xform.rotate_y(theta) @ xform.scale((s, s, s))
        out.append(np.asarray(m, np.float32))
    return out


def forest_scene(width, height, n_instances, n):
    """The instanced forest as an ``akari_tpu`` Scene."""
    import numpy as np

    from akari_tpu.core import transform as xform
    from akari_tpu.scene.arrays import make_camera
    from akari_tpu.scene.builtin import _quad, terrain_mesh
    from akari_tpu.scene.nodes import EmissiveMaterial, Instance, Mesh, Scene

    proto = terrain_mesh(n)
    shapes = [Instance(proto, m) for m in forest_transforms(n_instances)]
    lq = _quad((-2.0, 4.0, 2.0), (-2.0, 4.0, -2.0), (2.0, 4.0, -2.0), (2.0, 4.0, 2.0))
    shapes.append(Mesh(
        vertices=np.stack(lq).reshape(-1, 3),
        indices=np.arange(6, dtype=np.int64).reshape(-1, 3),
        materials=[EmissiveMaterial((14.0, 13.0, 11.0))],
        material_ids=np.zeros(2, np.int64),
    ))
    c2w = xform.look_at((6.0, 5.0, 9.0), (0.0, 0.3, 0.0))
    return Scene(shapes=shapes, camera=make_camera(c2w, 40.0, width, height))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import numpy as np

    import akari_tpu.scene.nodes as nodes
    from akari_tpu.integrators.path import PathConfig, render

    nodes.FLATTEN_MAX_TRIS = 1
    sc = forest_scene(WIDTH, HEIGHT, N_INSTANCES, TERRAIN_N)
    scene = sc.compile(intersector="bvh")
    if scene.instances is None:
        raise SystemExit("the forest did not compile two-level")
    img = np.asarray(
        render(scene, sc.camera, PathConfig(spp=SPP, max_depth=MAX_DEPTH), seed=SEED),
        np.float32,
    )
    if not np.all(np.isfinite(img)):
        raise SystemExit("reference render is not finite")
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    np.save(args.output, img)
    print(f"wrote {args.output}: shape {img.shape}, mean {float(img.mean()):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
