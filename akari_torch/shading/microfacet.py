"""Microfacet model ids (``akari_tpu/shading/microfacet.py``). The
component-SoA formulas themselves live in ``shading/soa.py``."""

GGX = 0
BECKMANN = 1
PHONG = 2
