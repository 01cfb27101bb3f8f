"""Write the bfloat16-variant golden image the PyTorch port is checked
against without JAX.

Renders the built-in Cornell box at 64x64, 4 spp, depth 5, seed 0 with the
JAX package (``akari_tpu``) on the CPU through the brute-force intersector
under ``RGB_BF16`` (radiance and throughput carried in bfloat16) and saves
the float32 [64, 64, 3] image as
``tests/data/torch_port_cornell64_spp4_d5_bf16.npy``. ``chip_smoke.py``
and ``tests/test_torch_variant.py`` render the same configuration with
``akari_torch`` and compare with the outlier budget of ``tests/_imgcmp.py``.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_bf16_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_cornell64_spp4_d5_bf16.npy")
WIDTH = HEIGHT = 64
SPP, MAX_DEPTH, SEED = 4, 5, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import numpy as np

    from akari_tpu.integrators.path import PathConfig, render
    from akari_tpu.scene.builtin import cornell_box
    from akari_tpu.utils.config import RGB_BF16

    sc = cornell_box(WIDTH, HEIGHT)
    scene = sc.compile(intersector="brute")
    img = np.asarray(
        render(scene, sc.camera,
               PathConfig(spp=SPP, max_depth=MAX_DEPTH, dtypes=RGB_BF16), seed=SEED),
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
