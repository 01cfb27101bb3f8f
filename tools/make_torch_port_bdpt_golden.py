"""Write the BDPT golden image the PyTorch port's bidirectional integrator is checked against.

Renders the built-in Cornell box ``cornell_box(64, 64)`` with the JAX
package's (``akari_tpu``) ``render_bdpt`` at ``BDPTConfig(spp=4)`` (eye
depth 4, light depth 3, light tracing on), seed 0, on the CPU through the
brute-force intersector, and saves the float32 [64, 64, 3] linear image
(radiance plus the light-tracing splat) as
``tests/data/torch_port_bdpt_cornell64_spp4.npy``. ``chip_smoke.py`` and
``tests/test_torch_bdpt.py`` render the same configuration with
``akari_torch`` and compare under the outlier budget of
``tests/_imgcmp.py``.

Usage: JAX_PLATFORMS=cpu python tools/make_torch_port_bdpt_golden.py [-o PATH]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_bdpt_cornell64_spp4.npy")
WIDTH = HEIGHT = 64
SPP, SEED = 4, 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)

    import numpy as np

    from akari_tpu.integrators.bdpt import BDPTConfig, render_bdpt
    from akari_tpu.scene.builtin import cornell_box

    sc = cornell_box(WIDTH, HEIGHT)
    scene = sc.compile(intersector="brute")
    img = np.asarray(render_bdpt(scene, sc.camera, BDPTConfig(spp=SPP), seed=SEED), np.float32)
    if not np.all(np.isfinite(img)):
        raise SystemExit("reference render is not finite")
    os.makedirs(os.path.dirname(args.output), exist_ok=True)
    np.save(args.output, img)
    print(f"wrote {args.output}: shape {img.shape}, mean {float(img.mean()):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
