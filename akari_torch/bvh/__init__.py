from .build import MAX_LEAF, build_bvh
