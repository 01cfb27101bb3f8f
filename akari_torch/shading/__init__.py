from . import bsdf, light, material, microfacet, texture
