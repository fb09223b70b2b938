"""cobevt_tpu_torch.models: the camera graphs (CorpBEVT, SinBEVT, the CVT
zoo of ``camera_bev_models``) and the nuScenes ``CrossViewTransformer``,
exported as ``cobevt_tpu/models/__init__.py`` does."""

from cobevt_tpu_torch.models.camera_bev_models import (
    MODEL_REGISTRY,
    CameraBEVConfig,
    CameraBEVModel,
    create_model,
)
from cobevt_tpu_torch.models.corpbevt import CorpBEVT, CorpBEVTConfig, SinBEVT
from cobevt_tpu_torch.models.fax import FAXConfig, FAXModule
from cobevt_tpu_torch.models.sinbevt_nuscenes import (
    CrossViewTransformer,
    PyramidAxialConfig,
    PyramidAxialEncoder,
)
