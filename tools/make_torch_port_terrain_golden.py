"""Write the terrain golden image the PyTorch port's tree walk is checked against.

Renders the built-in terrain ``terrain_scene(64, 64, n=64)`` (7,940
triangles, above DENSE_MAX_TRIS, so the port takes its tree route) at 4
spp, depth 5, seed 0 with the JAX package (``akari_tpu``) on the CPU
through the brute-force intersector and saves the float32 [64, 64, 3]
linear image as ``tests/data/torch_port_terrain64_spp4_d5.npy``.
``chip_smoke.py`` renders the same configuration with ``akari_torch`` on
the GPU and compares the two with the outlier budget of
``tests/_imgcmp.py``.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_terrain_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_terrain64_spp4_d5.npy")
WIDTH = HEIGHT = 64
TERRAIN_N = 64
SPP, MAX_DEPTH, SEED = 4, 5, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import numpy as np

    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.scene.builtin import terrain_scene

    sc = terrain_scene(WIDTH, HEIGHT, n=TERRAIN_N)
    scene = sc.compile(intersector="brute")
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
