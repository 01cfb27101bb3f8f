"""Write the digests of the PyTorch port's CPU scene compile that
``tests/test_torch_device.py`` holds ``compile(..., device="cpu")`` to.

For each scene of ``SCENES`` (the Cornell box, the terrain at n = 64 on
the tree route, and ``dryrun_scene`` compiled two-level under
``FLATTEN_MAX_TRIS = 1``) it records, per field of the compiled
``SceneArrays`` (nested tables by dotted path), the SHA-256 of a tensor's
bytes with its dtype and shape, or a static field's value;
``compile_seconds`` is left out. The file in the repository was written
from the port as it was before ``compile`` took a device (it compiled to
the CPU only), so the test shows that ``device="cpu"`` gives the same
tensors bit for bit.

Usage: python tools/make_torch_port_compile_digests.py [-o FILE] [--root DIR]
(``--root``: the checkout whose ``akari_torch`` to compile with).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "tests", "data", "torch_port_compile_digests.json")
SCENES = ("cornell", "terrain64", "two_level")


def scene_digest(obj, prefix=""):
    """{dotted field: {"sha256", "dtype", "shape"} or value} of a compiled
    scene, without ``compile_seconds``."""
    import torch

    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if f.name == "compile_seconds":
            continue
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            out[key] = {"sha256": hashlib.sha256(t.numpy().tobytes()).hexdigest(),
                        "dtype": str(t.dtype), "shape": list(t.shape),
                        "device": str(v.device)}
        elif dataclasses.is_dataclass(v):
            out.update(scene_digest(v, key + "."))
        else:
            out[key] = v
    return out


def compile_named(name, **kw):
    """One scene of ``SCENES`` compiled by the ``akari_torch`` on the path."""
    from akari_torch.scene import builtin, nodes

    if name == "cornell":
        return builtin.cornell_box(16, 16).compile(**kw)
    if name == "terrain64":
        return builtin.terrain_scene(16, 16, n=64).compile(**kw)
    old = nodes.FLATTEN_MAX_TRIS
    nodes.FLATTEN_MAX_TRIS = 1
    try:
        return builtin.dryrun_scene(16, 16).compile(**kw)
    finally:
        nodes.FLATTEN_MAX_TRIS = old


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", default=DEFAULT_OUT)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))

    from akari_torch.scene import nodes

    # a commit from before the device argument compiles to the CPU only
    kw = {"device": "cpu"} if "device" in inspect.signature(nodes.Scene.compile).parameters \
        else {}
    digests = {name: scene_digest(compile_named(name, **kw)) for name in SCENES}
    with open(args.output, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.output}: {', '.join(f'{k} {len(v)} fields' for k, v in digests.items())}")


if __name__ == "__main__":
    main()
