"""Kernels of the port: each wrapper launches a hand-written kernel (CUDA
C++, or Triton for K9 and K10) on CUDA tensors and runs its plain PyTorch
version on CPU tensors.  The model paths' kernels are ``cobevt::`` custom
ops (:data:`KERNEL_OPS`: the eval kernels and K5, the attention backward),
each with its work formula (``utils/flops.py``); K9-K12, which no model
path runs, are called through ``ctypes`` only."""

from cobevt_tpu_torch.ops import (
    conv2d,
    fused_cross_attention,
    fused_swap_fusion as _swap,
    int8_chain,
    window_attention,
)
from cobevt_tpu_torch.ops.bn_stats import bn_stats_bwd, bn_stats_fwd
from cobevt_tpu_torch.ops.conv2d import (
    fold_bn,
    fused_conv3x3,
    fused_conv3x3_int8,
    int8_absmax,
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
                   conv3x3_s8, int8_absmax, bn_stats_fwd, bn_stats_bwd,
                   fused_ffd, fused_ffd_bwd)


# the custom ops, by their name in the cobevt namespace
KERNEL_OPS = {op.name: op for op in (
    window_attention._K1, window_attention._K5, window_attention._K8,
    fused_cross_attention._K2,
    conv2d._K3, _swap._K4, _swap._K6, conv2d._K7, conv2d._A7,
    int8_chain._S8)}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = ["KERNEL_OPS", "KERNEL_WRAPPERS", "bn_stats_bwd", "bn_stats_fwd", "conv3x3_s8",
           "fold_bn", "forced_impl", "fused_conv3x3", "fused_conv3x3_int8",
           "fused_cross_view_attention", "fused_ffd", "fused_ffd_bwd",
           "fused_swap_fusion",
           "fused_swap_fusion_streaming",
           "fused_window_attention", "fused_window_attention_packed",
           "fused_window_attention_packed_bwd", "int8_absmax",
           "launch_counts", "reset_launch_counts"]
