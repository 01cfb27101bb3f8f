"""Ray-sharded rendering and the pixel loss over ``torch.distributed``
(``akari_tpu/parallel``)."""

from .mesh import initialize_distributed, make_ray_mesh
from .render import loss_and_image_sharded, render_sharded
