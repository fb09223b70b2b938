from cobevt_tpu_torch.models.lidar.bev_backbone import (  # noqa: F401
    AttBEVBackbone,
    AutoEncoder,
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
from cobevt_tpu_torch.models.lidar.second_models import (  # noqa: F401
    SecondConfig,
    SecondDetector,
    second_config_from_hypes,
)
from cobevt_tpu_torch.models.lidar.voxel_backbone import (  # noqa: F401
    DenseVoxelBackbone8x,
    scatter_voxels_dense,
)
