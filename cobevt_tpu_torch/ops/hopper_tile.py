"""The bare TMA + ``wgmma`` tile product of ``csrc/hopper_tile.cu``: the
check of the Hopper building blocks (``csrc/hopper.cuh``) that K1, K3, K8 and
K7 share, one product form at a time, against ``torch.matmul`` in f32 (the
8-bit forms exactly, as integers).

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

# variant -> (A shape, B shape, C shape, what C is); see the source.  bf16
# operands, f32 C
VARIANTS = {
    0: ((64, 64), (128, 64), (64, 128), "a @ b.T"),   # K3's product
    1: ((64, 32), (64, 32), (64, 64), "a @ b.T"),     # K1's q k^T
    2: ((64, 64), (64, 32), (64, 32), "a @ b"),       # K1's P v
}
# the 8-bit forms: s8 operands, s32 C
S8_VARIANTS = {
    3: ((64, 128), (128, 128), (64, 128), "a @ b.T"),  # A from shared memory
    4: ((64, 128), (128, 128), (64, 128), "a @ b.T"),  # K7's: A by ldmatrix
}


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("hopper_tile").cobevt_hopper_tile
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def tile_reference(a, b, variant: int):
    """What the tile computes: in f32 (TF32 off on the caller's side), or
    for the 8-bit forms exactly in integers (every sum of 128 products of
    s8 values is below 2^24, so the f32 product is exact)."""
    if variant in S8_VARIANTS:
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return (a.float() @ b.float().t()).to(torch.int32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
    a, b = a.float(), b.float()
    return a @ b if VARIANTS[variant][3] == "a @ b" else a @ b.t()


def tile_product(a, b, variant: int):
    """Launch the bare tile of ``variant`` on CUDA tensors of its shapes
    (bf16, or int8 for :data:`S8_VARIANTS`); returns C in f32 (int32)."""
    s8 = variant in S8_VARIANTS
    a_shape, b_shape, c_shape, _ = (S8_VARIANTS if s8 else VARIANTS)[variant]
    dt = torch.int8 if s8 else torch.bfloat16
    check_operand("a", a, a_shape, dt, a.device)
    check_operand("b", b, b_shape, dt, a.device)
    c = torch.empty(c_shape, dtype=torch.int32 if s8 else torch.float32,
                    device=a.device)
    err = _entry()(a.data_ptr(), b.data_ptr(), c.data_ptr(), variant,
                   a.device.index, torch.cuda.current_stream(a.device)
                   .cuda_stream)
    _build.check(err, f"hopper_tile variant {variant}")
    return c
