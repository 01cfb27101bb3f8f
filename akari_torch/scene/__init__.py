from .arrays import Camera, SceneArrays, make_camera
from .nodes import (
    ConstantTexture,
    DiffuseMaterial,
    EmissiveMaterial,
    GlossyMaterial,
    ImageTexture,
    Instance,
    Mesh,
    MirrorMaterial,
    MixMaterial,
    Scene,
)
