"""PyTorch / CUDA port of the AkariRender path tracer.

Mirrors the layout of ``akari_tpu`` (core, scene, bvh, ops, shading,
integrators, cli) so each module's counterpart is found by path. Plain
tensor code is PyTorch; the ray-triangle intersection kernel is
hand-written CUDA under ``kernels/csrc`` and built at first use.

The package imports torch and numpy only.
"""

__version__ = "0.1.0"
