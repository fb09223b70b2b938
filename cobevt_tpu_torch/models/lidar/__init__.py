from cobevt_tpu_torch.models.lidar.bev_backbone import (  # noqa: F401
    BaseBEVBackbone,
    DownsampleConv,
)
from cobevt_tpu_torch.models.lidar.misc import (  # noqa: F401
    height_compression,
    mean_vfe,
)
from cobevt_tpu_torch.models.lidar.pillar_encoder import (  # noqa: F401
    PFNLayer,
    PillarVFE,
    pillar_scatter,
)
from cobevt_tpu_torch.models.lidar.point_pillar_models import (  # noqa: F401
    PointPillarConfig,
    PointPillarFuseBEVT,
)
