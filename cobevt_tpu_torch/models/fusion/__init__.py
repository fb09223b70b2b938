"""cobevt_tpu_torch.models.fusion: FuseBEVT and the baseline fusion zoo."""

from cobevt_tpu_torch.models.fusion.swap_fusion import SwapFusionEncoder
