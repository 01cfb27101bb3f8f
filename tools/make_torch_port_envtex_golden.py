"""Write the env-lit textured terrain golden image the PyTorch port is checked against.

Writes the scene files of ``akari_torch.scene.builtin.write_envtex_terrain``
(the same writer ``chip_smoke.py`` uses at full size) at n=64, 64 x 64,
4 spp, depth 5, with a 64 x 64 albedo PNG and a 64 x 128 sky (.hdr), parses
them with the JAX package's (``akari_tpu``) SDL reader (its ``map_Kd`` PNG
through PIL, the sky through its RGBE reader), renders on the CPU through
the brute-force intersector at seed 0, and saves the float32 [64, 64, 3]
linear image as ``tests/data/torch_port_envtex64_spp4_d5.npy``.
``chip_smoke.py`` and ``tests/test_torch_envmap.py`` render the same files
with ``akari_torch`` and compare under the outlier budget of
``tests/_imgcmp.py``.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_envtex_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_envtex64_spp4_d5.npy")
# write_envtex_terrain's arguments for the golden scene
SCENE = dict(n=64, res=64, spp=4, depth=5, tex_res=64, sky_hw=(64, 128))
SEED = 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import numpy as np

    from akari_torch.scene.builtin import write_envtex_terrain
    from akari_tpu.integrators.path import render
    from akari_tpu.scene import sdl

    with tempfile.TemporaryDirectory() as tmp:
        node = sdl.parse_file(write_envtex_terrain(tmp, **SCENE)).exports["scene"]
        scene = node.compile(intersector="brute")
    if scene.env_image is None or not scene.textures.has_images:
        raise SystemExit("the scene lost its environment or its image texture")
    img = np.asarray(render(scene, node.camera, node.integrator, seed=SEED), np.float32)
    if not np.all(np.isfinite(img)):
        raise SystemExit("reference render is not finite")
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    np.save(args.output, img)
    print(f"wrote {args.output}: shape {img.shape}, mean {float(img.mean()):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
