from . import distribution, rng, spectrum, transform, vecmath
