"""Kernels of the port: each wrapper launches a hand-written kernel (CUDA
C++, or Triton for K9 and K10) on CUDA tensors and runs its plain PyTorch
version on CPU tensors."""

from cobevt_tpu_torch.ops.bn_stats import bn_stats_bwd, bn_stats_fwd
from cobevt_tpu_torch.ops.conv2d import (
    fold_bn,
    fused_conv3x3,
    fused_conv3x3_int8,
)
from cobevt_tpu_torch.ops.dispatch import forced_impl
from cobevt_tpu_torch.ops.ffd_fused import fused_ffd, fused_ffd_bwd
from cobevt_tpu_torch.ops.fused_cross_attention import (
    fused_cross_view_attention,
)
from cobevt_tpu_torch.ops.fused_swap_fusion import (
    fused_swap_fusion,
    fused_swap_fusion_streaming,
)
from cobevt_tpu_torch.ops.int8_chain import conv3x3_s8
from cobevt_tpu_torch.ops.window_attention import (
    fused_window_attention,
    fused_window_attention_packed,
    fused_window_attention_packed_bwd,
)

KERNEL_WRAPPERS = (fused_window_attention_packed, fused_cross_view_attention,
                   fused_conv3x3, fused_swap_fusion,
                   fused_window_attention_packed_bwd, fused_window_attention,
                   fused_swap_fusion_streaming, fused_conv3x3_int8,
                   conv3x3_s8, bn_stats_fwd, bn_stats_bwd, fused_ffd,
                   fused_ffd_bwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = ["KERNEL_WRAPPERS", "bn_stats_bwd", "bn_stats_fwd", "conv3x3_s8",
           "fold_bn", "forced_impl", "fused_conv3x3", "fused_conv3x3_int8",
           "fused_cross_view_attention", "fused_ffd", "fused_ffd_bwd",
           "fused_swap_fusion",
           "fused_swap_fusion_streaming",
           "fused_window_attention", "fused_window_attention_packed",
           "fused_window_attention_packed_bwd", "launch_counts",
           "reset_launch_counts"]
