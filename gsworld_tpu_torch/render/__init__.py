"""The GS render: camera bridge, projection, binning (emit kernel + sort)
and compositing (compositor kernel)."""

from gsworld_tpu_torch.render.camera import (  # noqa: F401
    GSCamera,
    RasterConfig,
    cam_maniskill2gs,
    camera_from_opencv,
    make_camera,
    projection_matrix,
)
from gsworld_tpu_torch.render.project import (  # noqa: F401
    Projected,
    project_gaussians,
)
from gsworld_tpu_torch.render.rasterize import (  # noqa: F401
    render,
    render_uint8,
)
