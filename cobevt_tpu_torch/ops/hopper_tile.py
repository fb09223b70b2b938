"""The bare TMA + ``wgmma`` tile product of ``csrc/hopper_tile.cu``: the
check of the Hopper building blocks (``csrc/hopper.cuh``) that K1, K3 and K8
share, one product form at a time, against ``torch.matmul`` in f32.

Not on any model path; ``chip_smoke.py`` and the GPU tests call it before
they hold the kernels that use the same descriptors against their plain
versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cobevt_tpu_torch.ops import _build
from cobevt_tpu_torch.ops.dispatch import check_operand

# variant -> (A shape, B shape, C shape, what C is); see the source
VARIANTS = {
    0: ((64, 64), (128, 64), (64, 128), "a @ b.T"),   # K3's product
    1: ((64, 32), (64, 32), (64, 64), "a @ b.T"),     # K1's q k^T
    2: ((64, 64), (64, 32), (64, 32), "a @ b"),       # K1's P v
}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("hopper_tile").cobevt_hopper_tile
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_reference(a, b, variant: int):
    """What the tile computes, in f32 (TF32 off on the caller's side)."""
    a, b = a.float(), b.float()
    return a @ b if VARIANTS[variant][3] == "a @ b" else a @ b.t()


def tile_product(a, b, variant: int):
    """Launch the bare tile of ``variant`` on bf16 CUDA tensors of its
    shapes; returns C in f32."""
    a_shape, b_shape, c_shape, _ = VARIANTS[variant]
    check_operand("a", a, a_shape, torch.bfloat16, a.device)
    check_operand("b", b, b_shape, torch.bfloat16, a.device)
    c = torch.empty(c_shape, dtype=torch.float32, device=a.device)
    err = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), variant,
                   a.device.index, torch.cuda.current_stream(a.device)
                   .cuda_stream)
    _build.check(err, f"hopper_tile variant {variant}")
    return c
