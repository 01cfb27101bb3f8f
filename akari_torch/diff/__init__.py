"""Differentiable rendering: parameters, the Adam inverse-rendering loop
(``inverse.py``) and the edge-sampled boundary term (``boundary.py``)."""
