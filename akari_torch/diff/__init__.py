"""Differentiable rendering: parameters, the Adam inverse-rendering loop
(``inverse.py``) and the edge-sampled boundary term (``boundary.py``)."""

from .inverse import InverseConfig, apply_params, inverse_render, scene_params
