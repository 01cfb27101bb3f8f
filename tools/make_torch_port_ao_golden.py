"""Write the ambient-occlusion golden image the PyTorch port's AO integrator is checked against.

Renders the built-in terrain ``terrain_scene(64, 64, n=64)`` (7,940
triangles: the port takes its tree route) with the JAX package's
(``akari_tpu``) ``render_ao`` at ``AOConfig()`` (16 spp), seed 0, on the
CPU through the brute-force intersector, and saves the float32
[64, 64, 3] image as ``tests/data/torch_port_ao_terrain64_spp16.npy``.
``chip_smoke.py`` and ``tests/test_torch_ao.py`` render the same
configuration with ``akari_torch`` and compare under the outlier budget
of ``tests/_imgcmp.py``.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_ao_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_ao_terrain64_spp16.npy")
WIDTH = HEIGHT = 64
TERRAIN_N = 64
SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import numpy as np

    from akari_tpu.integrators.ao import AOConfig, render_ao
    from akari_tpu.scene.builtin import terrain_scene

    sc = terrain_scene(WIDTH, HEIGHT, n=TERRAIN_N)
    scene = sc.compile(intersector="brute")
    img = np.asarray(render_ao(scene, sc.camera, AOConfig(), seed=SEED), np.float32)
    if not np.all(np.isfinite(img)):
        raise SystemExit("reference render is not finite")
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    np.save(args.output, img)
    print(f"wrote {args.output}: shape {img.shape}, mean {float(img.mean()):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
