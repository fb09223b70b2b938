"""The CUDA kernels of the port against their plain versions, on the card.

Marked ``gpu``: every test skips without a CUDA device.  On a machine
with one:

  python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

builds K1-K12 with nvcc (sm_90a) and compiles the Triton route of K9 and
K10 (shapes the CUDA kernel does not take) on first use (``--noconftest``:
the repo's conftest sets up JAX, which these tests do not need).  K7 and the int8 chain's conv (the second entry of K7's source)
must EQUAL their plain versions bit for bit (equal integers, the same unfused
f32 epilogue or exact replacements of it, one rounding to bf16 or to a tick;
the clipped share is a count over the same size); K9 and K10 agree with theirs
within 1e-4 of the largest sum (f32 sums in another order) on the route
``ops/bn_stats.py:kernel_path`` picks, propagate NaN as ``torch.maximum``
does, and repeat bit for bit.  Tolerances: f32
1e-4 abs / 1e-4 rel (sums in another order); bf16 2e-2 abs / 2e-2 rel
(both sides round an f32 result to bf16 once, or at the same casts of one
chain: K2), and for K4 in bf16 5e-2 abs / 2e-2 rel: its residual state is
rounded to bf16 after each of 2*depth sublayers, and a one-ulp flip at
|x| ~ 4 (0.03) carries on through the sublayers after it; K6 is held to
the same bound for the same reason.  K5's
gradients are sums of up to Tq or Tk terms, so their tolerance scales with
the largest value of the plain version's result: f32 1e-4 of it (sums in
another order), bf16 2e-2 of it (the kernel takes the row maximum per head,
the plain version over all heads as the TPU body does, so the exp rounds to
bf16 at another place: one bf16 ulp on a weight); dbias sums the windows
through per-chunk partials added in a fixed order, so dq, dk, dv and dbias
all repeat bit for bit, at the nuScenes train step's ragged query windows
(600, 100 and 625 rows) too.  K11's output is held like K1's; K12's
seven gradients like K5's (dx in the compute dtype, the parameter gradients
f32 sums over up to 84,480 rows), and a second call must give the same bits
(no atomics), on both routes (``ops/ffd_fused.py:kernel_path``).
"""

import pytest
import torch

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.nn.layers import BasicBlock
from cobevt_tpu_torch.ops import bn_stats
from cobevt_tpu_torch.ops.bn_stats import bn_stats_bwd, bn_stats_fwd
from cobevt_tpu_torch.ops.conv2d import (
    _launch_int8,
    fold_amax_,
    fused_conv3x3,
    fused_conv3x3_int8,
    int8_absmax,
    int8_tile_plan,
    new_amax_slots,
    pack_conv3x3_weight,
    pack_int8_weight,
)
from cobevt_tpu_torch.ops.int8_chain import (
    conv3x3_s8,
    pack_s8_weight,
    quantize_dynamic,
    s8_plan,
)
from cobevt_tpu_torch.nn.resnet import ResNetTrunk
from cobevt_tpu_torch.ops.ffd_fused import (
    fused_ffd,
    fused_ffd_bwd,
    kernel_path as ffd_kernel_path,
)
from cobevt_tpu_torch.ops.fused_cross_attention import (
    LAUNCHES_PER_CALL,
    fused_cross_view_attention,
    kernel_path,
)
from cobevt_tpu_torch.ops.fused_swap_fusion import (
    fused_swap_fusion,
    fused_swap_fusion_streaming,
    k4_kernel_path,
    launches_per_call,
)
from cobevt_tpu_torch.ops.hopper_tile import (
    S8_VARIANTS,
    VARIANTS,
    tile_product,
    tile_reference,
)
from cobevt_tpu_torch.ops.window_attention import (
    attention_tile_plan,
    fused_window_attention,
    fused_window_attention_packed,
    fused_window_attention_packed_bwd,
    packed_bwd_kernel_ok,
)
from cobevt_tpu_torch.tools.micro_bn_stats import SHAPES as BN_SHAPES

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
K4_TOL = {torch.float32: TOL[torch.float32],
          torch.bfloat16: dict(atol=5e-2, rtol=2e-2)}


@pytest.fixture
def gen():
    """A seeded CUDA generator; TF32 off so the f32 plain versions (cuDNN
    convolutions included) run in full f32 precision."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hopper_tile_matches_matmul(gen, variant):
    """One bare TMA + wgmma tile of each product form K1, K3 and K8 use
    (csrc/hopper_tile.cu), against torch.matmul in f32: bf16 inputs, exact
    products, f32 sums in another order."""
    a_shape, b_shape, _, _ = VARIANTS[variant]
    a = torch.randn(*a_shape, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(*b_shape, generator=gen, device="cuda").to(torch.bfloat16)
    got = tile_product(a, b, variant)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, tile_reference(a, b, variant), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("variant", sorted(S8_VARIANTS))
def test_hopper_s8_tile_matches_integer_matmul(gen, variant):
    """The 8-bit wgmma forms of csrc/hopper.cuh (A from shared memory, and
    K7's: A by ldmatrix from 144-byte rows into registers) against the
    exact integer product, twice, bit for bit."""
    a_shape, b_shape, _, _ = S8_VARIANTS[variant]
    a = torch.randint(-127, 128, a_shape, generator=gen, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, b_shape, generator=gen, device="cuda",
                      dtype=torch.int8)
    got = tile_product(a, b, variant)
    again = tile_product(a, b, variant)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32
    assert torch.equal(got, tile_reference(a, b, variant))
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask",
                                    "bias+weight", "weight"])
def test_k1_kernel_matches_plain(gen, dtype, D, extras):
    G, H, Tq, Tk = 3, 4, 72, 40        # ragged query and key tiles

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, Tq, H * D) * 0.3).to(dtype)
    k, v = rand(G, Tk, H * D).to(dtype), rand(G, Tk, H * D).to(dtype)
    bias = rand(Tq, H * Tk) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (rand(G, Tk) > 0).float()
        mask[1] = 0.0                  # a fully masked window
    weight = None
    if "weight" in extras:
        weight = ((rand(G, Tq, H * Tk) > -1).float() / 0.84).to(dtype)
    before = fused_window_attention_packed.launches
    got = fused_window_attention_packed(q, k, v, H, bias, mask, weight)
    assert fused_window_attention_packed.launches == before + 1
    want = fused_window_attention_packed(q, k, v, H, bias, mask, weight,
                                         impl="torch")
    assert fused_window_attention_packed.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fully_masked", [False, True])
def test_k1_kernel_matches_plain_at_the_lidar_stock_shape(gen, dtype,
                                                          fully_masked):
    """The fusion attention of the stock cooperative-LiDAR path, which the
    K6 path is held against: the 264 windows of the 96 x 176 map, 5 agents x
    8 x 8 tokens, 8 heads of 32, f32 bias and key mask."""
    G, H, D, T = 264, 8, 32, 320

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, T, H * D) * D ** -0.5).to(dtype)
    k, v = rand(G, T, H * D).to(dtype), rand(G, T, H * D).to(dtype)
    bias = rand(T, H * T) * 0.5
    mask = (torch.rand(G, T, generator=gen, device="cuda") > 0.3).float()
    if fully_masked:
        mask[3] = 0.0
    before = fused_window_attention_packed.launches
    got = fused_window_attention_packed(q, k, v, H, bias, mask)
    assert fused_window_attention_packed.launches == before + 1
    want = fused_window_attention_packed(q, k, v, H, bias, mask,
                                         impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask",
                                    "bias+weight", "weight"])
@pytest.mark.parametrize("G,Tq,Tk", [(80, 256, 256), (80, 256, 200),
                                     (5, 1024, 1024), (3, 136, 72)])
def test_k1_kernel_matches_plain_at_both_tile_plans(gen, D, extras, G, Tq,
                                                    Tk):
    """bf16 with whole query tiles (256, 1024) and a ragged last one (136),
    a ragged key tile (200, 72) and a fully masked window; 80 windows give
    the grid more blocks than the card holds at once."""
    H = 4
    rows, blocks = attention_tile_plan(G, H, Tq)
    assert rows * blocks >= G * H * Tq

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, Tq, H * D) * D ** -0.5).to(torch.bfloat16)
    k = rand(G, Tk, H * D).to(torch.bfloat16)
    v = rand(G, Tk, H * D).to(torch.bfloat16)
    bias = rand(Tq, H * Tk) * 0.5 if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (rand(G, Tk) > -0.5).float()
        mask[1] = 0.0
    weight = None
    if "weight" in extras:
        weight = ((rand(G, Tq, H * Tk) > -1.2).float() / 0.9).to(
            torch.bfloat16)
    got = fused_window_attention_packed(q, k, v, H, bias, mask, weight)
    want = fused_window_attention_packed(q, k, v, H, bias, mask, weight,
                                         impl="torch")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


def _assert_close_scaled(got, want, dtype, name):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = max(float(want.abs().max()), 1e-3)
    assert torch.isfinite(got).all(), name
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale,
                               rtol=tol, msg=lambda m: f"{name}: {m}")


def _k5_inputs(gen, dtype, G, H, D, Tq, Tk, extras):
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, Tq, H * D) * 0.3).to(dtype)
    k, v = rand(G, Tk, H * D).to(dtype), rand(G, Tk, H * D).to(dtype)
    g = rand(G, Tq, H * D).to(dtype)
    bias = rand(Tq, H * Tk) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (rand(G, Tk) > 0).float()
        mask[1] = 0.0                  # a fully masked window
    return q, k, v, g, bias, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask"])
@pytest.mark.parametrize("Tq,Tk", [(72, 40), (128, 192)])
def test_k5_kernel_matches_plain(gen, dtype, D, extras, Tq, Tk):
    G, H = 3, 4                        # (72, 40): ragged tiles
    q, k, v, g, bias, mask = _k5_inputs(gen, dtype, G, H, D, Tq, Tk, extras)
    out = fused_window_attention_packed(q, k, v, H, bias, mask)
    before = fused_window_attention_packed_bwd.launches
    got = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    assert fused_window_attention_packed_bwd.launches == before + 1
    want = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask,
                                             impl="torch")
    assert fused_window_attention_packed_bwd.launches == before + 1
    again = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), got, want, again):
        assert (a is None) == (b is None) == (
            name == "dbias" and bias is None)
        if a is not None:
            assert a.dtype == (torch.float32 if name == "dbias" else dtype)
            _assert_close_scaled(a, b, dtype, name)
            assert torch.equal(a, c), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_kernel_matches_plain_at_the_lidar_shape(gen, dtype):
    """The LiDAR train step's attention backward: 264 windows of 320 tokens,
    8 heads of 32, bias and communication mask, one window fully masked."""
    G, H, D, T = 264, 8, 32, 320
    q, k, v, g, bias, mask = _k5_inputs(gen, dtype, G, H, D, T, T,
                                        "bias+mask")
    assert packed_bwd_kernel_ok(q, k, None, H)
    out = fused_window_attention_packed(q, k, v, H, bias, mask)
    got = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    want = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask,
                                             impl="torch")
    again = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), got, want, again):
        _assert_close_scaled(a, b, dtype, name)
        assert torch.equal(a, c), name


# (G, Tq, Tk, heads) of chip_smoke.py:K5_CASES: the camera train step's
# five attention shapes and the LiDAR step's fusion attention
K5_PATH_SHAPES = [(320, 1024, 256, 4), (320, 256, 256, 4), (80, 256, 256, 4),
                  (5, 1024, 1024, 4), (16, 320, 320, 4), (264, 320, 320, 8)]


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask"])
@pytest.mark.parametrize("G,Tq,Tk,H", K5_PATH_SHAPES)
def test_k5_bf16_kernel_matches_plain_at_the_path_shapes(gen, D, extras, G,
                                                         Tq, Tk, H):
    q, k, v, g, bias, mask = _k5_inputs(gen, torch.bfloat16, G, H, D, Tq,
                                        Tk, extras)
    out = fused_window_attention_packed(q, k, v, H, bias, mask)
    got = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    want = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask,
                                             impl="torch")
    again = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), got, want, again):
        assert (a is None) == (b is None) == (
            name == "dbias" and bias is None)
        if a is not None:
            _assert_close_scaled(a, b, torch.bfloat16, name)
            assert torch.equal(a, c), name


@pytest.mark.parametrize("G,Tq,Tk,H,extras", [
    (320, 1024, 256, 4, ""), (5, 1024, 1024, 4, ""),
    (16, 320, 320, 4, "bias+mask"), (264, 320, 320, 8, "bias+mask"),
    (3, 72, 40, 4, "bias+mask")])
def test_k5_bf16_repeats_bit_for_bit(gen, G, Tq, Tk, H, extras):
    """20 launches give the same bits in dq, dk, dv and dbias: no dbias
    entry has two writers (a block sums a chunk of windows in order), then
    an ordered addition over the chunks."""
    q, k, v, g, bias, mask = _k5_inputs(gen, torch.bfloat16, G, H, 32, Tq,
                                        Tk, extras)
    out = fused_window_attention_packed(q, k, v, H, bias, mask)
    first = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    for _ in range(20):
        again = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias,
                                                  mask)
        for a, b in zip(first, again):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("G,Tq,Tk,H,extras", [
    (320, 1024, 256, 4, ""), (320, 256, 256, 4, ""), (80, 256, 256, 4, ""),
    (5, 1024, 1024, 4, ""), (16, 320, 320, 4, "bias+mask"),
    (264, 320, 320, 8, "bias+mask"), (3, 72, 40, 4, "bias+mask")])
def test_k5_fed_by_k1_statistics_on_the_train_path(gen, G, Tq, Tk, H,
                                                   extras):
    """Autograd in bf16: K1 writes the row statistics in the forward, K5
    takes them and skips its own sweep; one K5 launch, within K5's
    tolerance of the plain backward and of K5 alone."""
    q, k, v, g, bias, mask = _k5_inputs(gen, torch.bfloat16, G, H, 32, Tq,
                                        Tk, extras)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    b_leaf = None if bias is None else bias.clone().requires_grad_()
    before = fused_window_attention_packed_bwd.launches
    out = fused_window_attention_packed(*leaves, H, b_leaf, mask)
    out.backward(g)
    torch.cuda.synchronize()
    assert fused_window_attention_packed_bwd.launches == before + 1
    grads = [t.grad for t in leaves] + [None if b_leaf is None
                                        else b_leaf.grad]
    want = fused_window_attention_packed_bwd(q, k, v, g, out.detach(), H,
                                             bias, mask, impl="torch")
    alone = fused_window_attention_packed_bwd(q, k, v, g, out.detach(), H,
                                              bias, mask)
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), grads, want,
                             alone):
        if a is not None:
            _assert_close_scaled(a, b, torch.bfloat16, name)
            _assert_close_scaled(a, c, torch.bfloat16, name)


# (G, Tq, Tk, heads) of chip_smoke.py:K5_NUSC_CASES: the nuScenes train
# step's K5 calls at B 8 (stage 0's local and grid branches, stage 1, stage
# 2: windows of 600, 100 and 625 queries), then ragged windows of 1, 13 and
# 70 queries (one row of a tile, part of an 8-row group, a second tile of 6)
K5_NUSC_SHAPES = [(800, 600, 432, 1), (800, 100, 432, 1), (200, 100, 432, 2),
                  (8, 625, 2520, 4)]
K5_RAGGED_SHAPES = [(3, 1, 40, 4), (3, 13, 40, 4), (2, 70, 64, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Tq,Tk,H", K5_NUSC_SHAPES + K5_RAGGED_SHAPES)
def test_k5_kernel_matches_plain_at_ragged_query_windows(gen, dtype, G, Tq,
                                                         Tk, H):
    """K5 at a Tq that is no multiple of 8 (the bf16 route's statistics map
    at a row pitch of Tq rounded up to 4 floats; the f32 route's row
    kernels clamped by row), both routes against the plain version, and a
    second call equal bit for bit."""
    q, k, v, g, bias, mask = _k5_inputs(gen, dtype, G, H, 32, Tq, Tk, "")
    assert packed_bwd_kernel_ok(q, k, None, H)
    out = fused_window_attention_packed(q, k, v, H)
    before = fused_window_attention_packed_bwd.launches
    got = fused_window_attention_packed_bwd(q, k, v, g, out, H)
    assert fused_window_attention_packed_bwd.launches == before + 1
    want = fused_window_attention_packed_bwd(q, k, v, g, out, H,
                                             impl="torch")
    again = fused_window_attention_packed_bwd(q, k, v, g, out, H)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, again):
        _assert_close_scaled(a, b, dtype, name)
        assert torch.equal(a, c), name
    assert got[3] is None


@pytest.mark.parametrize("extras", ["bias", "mask", "bias+mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Tq,Tk,H", K5_RAGGED_SHAPES)
def test_k5_ragged_query_windows_with_bias_and_mask(gen, dtype, extras, G,
                                                    Tq, Tk, H):
    """The other operands at a ragged Tq: the bias box's rows past Tq are
    zero-filled too, dbias keeps Tq rows, a fully masked window stays
    exact."""
    q, k, v, g, bias, mask = _k5_inputs(gen, dtype, G, H, 32, Tq, Tk,
                                        extras)
    out = fused_window_attention_packed(q, k, v, H, bias, mask)
    got = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    want = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask,
                                             impl="torch")
    again = fused_window_attention_packed_bwd(q, k, v, g, out, H, bias, mask)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv", "dbias"), got, want, again):
        assert (a is None) == (b is None) == (name == "dbias" and
                                              bias is None)
        if a is not None:
            _assert_close_scaled(a, b, dtype, name)
            assert torch.equal(a, c), name


@pytest.mark.parametrize("G,Tq,Tk,H", K5_NUSC_SHAPES + K5_RAGGED_SHAPES)
def test_k5_fed_by_k1_statistics_at_ragged_query_windows(gen, G, Tq, Tk, H):
    """The nuScenes train step's path in bf16: K1 writes the row statistics
    at the padded pitch, K5 reads them through its TMA map; one K5 launch,
    within K5's tolerance of the plain backward and of K5 alone, and the
    same bits on a second backward."""
    q, k, v, g, _, _ = _k5_inputs(gen, torch.bfloat16, G, H, 32, Tq, Tk, "")
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = fused_window_attention_packed_bwd.launches
        out = fused_window_attention_packed(*leaves, H)
        out.backward(g)
        torch.cuda.synchronize()
        assert fused_window_attention_packed_bwd.launches == before + 1
        runs.append([t.grad for t in leaves])
    want = fused_window_attention_packed_bwd(q, k, v, g, out.detach(), H,
                                             impl="torch")
    alone = fused_window_attention_packed_bwd(q, k, v, g, out.detach(), H)
    for name, a, b, c, d in zip(("dq", "dk", "dv"), runs[0], want, alone,
                                runs[1]):
        _assert_close_scaled(a, b, torch.bfloat16, name)
        _assert_close_scaled(a, c, torch.bfloat16, name)
        assert torch.equal(a, d), name


FFD_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def _ffd_operands(gen, dtype, N, D, M):
    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    return (rand(N, D, scale=0.3).to(dtype), rand(D, scale=0.2) + 1.0,
            rand(D, scale=0.1), rand(D, M, scale=0.05).to(dtype),
            rand(M, scale=0.1), rand(M, D, scale=0.05).to(dtype),
            rand(D, scale=0.1), rand(N, D).to(dtype))


# the device kernels one K12 call launches on each route (csrc/ffd_fused.cu)
FFD_BWD_LAUNCHES = {
    "wgmma": {"bwd_rows_wgmma": 1, "bwd_weights_wgmma": 1,
              "add_partials_kernel": 2},
    "rows": {"ffd_bwd_rows_kernel": 1, "ffd_bwd_weights_kernel": 1,
             "add_partials_kernel": 2},
}


def _device_launches(fn):
    """{kernel name: launches} of the device kernels of csrc/ffd_fused.cu
    that ``fn`` runs (PyTorch's own copies left out), from torch.profiler
    (template arguments and namespaces stripped)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        name = e.key[5:] if e.key.startswith("void ") else e.key
        name = name.replace("(anonymous namespace)::", "")
        name = name.split("<")[0].split("(")[0].split("::")[-1].strip()
        if us > 0 and any(k in name for k in ("ffd", "wgmma", "partials")):
            out[name] = out.get(name, 0) + e.count
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (84480, 256, 512),      # the LiDAR fusion token count
    (1000, 128, 256),       # rows divide neither 16 nor 64
    (17, 64, 64),           # one ragged row block, the narrowest widths
    (4096, 256, 1024),      # a wider hidden layer
    (2000, 256, 192),       # M not a multiple of 128: the row kernels in bf16
])
def test_k11_k12_kernels_match_plain(gen, dtype, shape):
    *operands, dy = _ffd_operands(gen, dtype, *shape)
    x, gamma, beta, w1, b1, w2, b2 = operands
    route = ffd_kernel_path(*shape, dtype)
    assert route == ("wgmma" if dtype == torch.bfloat16 and shape[1] >= 128
                     and shape[2] % 128 == 0 else "rows")
    before = (fused_ffd.launches, fused_ffd_bwd.launches)
    with torch.no_grad():
        got = fused_ffd(*operands)
        want = fused_ffd(*operands, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    grads = fused_ffd_bwd(x, dy, gamma, beta, w1, b1, w2)
    again = fused_ffd_bwd(x, dy, gamma, beta, w1, b1, w2)
    plain = fused_ffd_bwd(x, dy, gamma, beta, w1, b1, w2, impl="torch")
    torch.cuda.synchronize()
    assert (fused_ffd.launches, fused_ffd_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    for name, a, b, c in zip(FFD_NAMES, grads, again, plain):
        assert a.dtype == (dtype if name == "dx" else torch.float32)
        assert torch.equal(a, b), name
        _assert_close_scaled(a, c, dtype, name)
    # one call: the route's four launches, counted once by the wrapper
    launches = _device_launches(
        lambda: fused_ffd_bwd(x, dy, gamma, beta, w1, b1, w2))
    assert launches == FFD_BWD_LAUNCHES[route], launches
    assert fused_ffd_bwd.launches == before[1] + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffd_autograd_on_the_card(gen, dtype):
    """The autograd function end to end: K11 forward, K12 backward, every
    gradient in its operand's dtype, against the plain versions."""
    *operands, dy = _ffd_operands(gen, dtype, 2000, 128, 256)
    results = {}
    for impl in ("kernel", "torch"):
        leaves = [t.clone().requires_grad_() for t in operands]
        fused_ffd(*leaves, impl=impl).backward(dy)
        results[impl] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for name, t, a, b in zip(FFD_NAMES, operands, results["kernel"],
                             results["torch"]):
        assert a.dtype == t.dtype
        _assert_close_scaled(a, b, dtype, name)


def test_k11_k12_reject_what_they_do_not_take(gen):
    *operands, dy = _ffd_operands(gen, torch.float32, 64, 96, 128)
    with pytest.raises(ValueError, match="K11/K12"):
        fused_ffd(*operands)                       # D not a multiple of 64
    *operands, dy = _ffd_operands(gen, torch.float32, 64, 512, 512)
    with pytest.raises(ValueError, match="K11/K12"):
        fused_ffd(*operands)                       # D beyond 256
    *operands, dy = _ffd_operands(gen, torch.float32, 64, 64, 64)
    operands[3] = operands[3].bfloat16()           # w1 in another dtype
    with pytest.raises(ValueError, match="w1"):
        fused_ffd(*operands)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("extras", ["bias+mask", "bias+weight"])
def test_packed_attention_backward_on_the_card(gen, dtype, extras):
    """autograd through the wrapper: K1 forward and K5 backward (or the
    composite backward with a weight) against the plain versions."""
    G, H, D, Tq, Tk = 3, 4, 32, 64, 64
    q, k, v, g, bias, mask = _k5_inputs(gen, dtype, G, H, D, Tq, Tk, extras)
    weight = None
    if "weight" in extras:
        weight = ((torch.rand(G, Tq, H * Tk, generator=gen, device="cuda")
                   > 0.2).float() / 0.8).to(dtype)
    grads = {}
    for impl in ("kernel", "torch"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        ops.reset_launch_counts()
        out = fused_window_attention_packed(*leaves[:3], H, leaves[3], mask,
                                            weight, impl=impl)
        out.backward(g)
        counts = ops.launch_counts()
        kernel = int(impl == "kernel")
        assert counts["fused_window_attention_packed"] == kernel
        assert counts["fused_window_attention_packed_bwd"] == (
            kernel if packed_bwd_kernel_ok(q, k, weight, H) else 0)
        grads[impl] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), grads["kernel"],
                          grads["torch"]):
        _assert_close_scaled(a, b, dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("extras", ["", "bias", "mask", "bias+mask"])
def test_k8_kernel_matches_plain(gen, dtype, D, extras):
    G, H, Tq, Tk = 3, 4, 72, 40

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, H, Tq, D) * 0.3).to(dtype)
    k, v = rand(G, H, Tk, D).to(dtype), rand(G, H, Tk, D).to(dtype)
    bias = rand(H, Tq, Tk) if "bias" in extras else None
    mask = None
    if "mask" in extras:
        mask = (rand(G, Tk) > 0).float()
        mask[1] = 0.0
    before = fused_window_attention.launches
    got = fused_window_attention(q, k, v, bias, mask)
    assert fused_window_attention.launches == before + 1
    want = fused_window_attention(q, k, v, bias, mask, impl="torch")
    assert fused_window_attention.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("extras", ["bias+mask", "mask"])
@pytest.mark.parametrize("G,Tq,Tk", [(80, 256, 256), (3, 72, 40)])
def test_k8_kernel_matches_plain_at_both_tile_plans(gen, extras, G, Tq, Tk):
    H, D = 4, 32

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q = (rand(G, H, Tq, D) * D ** -0.5).to(torch.bfloat16)
    k = rand(G, H, Tk, D).to(torch.bfloat16)
    v = rand(G, H, Tk, D).to(torch.bfloat16)
    bias = rand(H, Tq, Tk) if "bias" in extras else None
    mask = (rand(G, Tk) > -0.5).float()
    mask[1] = 0.0
    got = fused_window_attention(q, k, v, bias, mask)
    want = fused_window_attention(q, k, v, bias, mask, impl="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 9, 7, 32, 48),          # wgmma, C % 64 == 32: half-filled K step
    (1, 8, 8, 96, 64),          # wgmma, C % 64 == 32 after a full K step
    (1, 16, 16, 128, 128),      # wgmma path in bf16
    (2, 5, 6, 16, 24),          # C % 32 != 0: scalar path in bf16 too
    (2, 64, 64, 128, 128),      # wgmma, 2 x 64 boxes (layer2)
    (2, 32, 32, 256, 256),      # wgmma, 4 x 32 boxes (layer3)
    (2, 16, 16, 512, 512),      # wgmma, 8 x 16 boxes (layer4)
    (2, 9, 7, 64, 48),          # wgmma, 16 x 8 boxes past the edge, O < 128
    (1, 3, 200, 64, 136),       # wgmma, W > 128: two boxes a row
    # chip_smoke.py:K3_SINBEVT_CASES: one SinBEVT-OPV2V vehicle (4 camera
    # images of 512^2) at layers 2-4
    (4, 64, 64, 128, 128),
    (4, 32, 32, 256, 256),
    (4, 16, 16, 512, 512),
])
@pytest.mark.parametrize("residual", [False, True])
def test_k3_kernel_matches_plain(gen, dtype, shape, residual):
    N, H, W, C, O = shape
    x = torch.randn(N, H, W, C, generator=gen, device="cuda").to(dtype)
    w = torch.randn(3, 3, C, O, generator=gen, device="cuda") * 0.05
    shift = torch.randn(O, generator=gen, device="cuda")
    res = (torch.randn(N, H, W, O, generator=gen, device="cuda").to(dtype)
           if residual else None)
    got = fused_conv3x3(x, w, shift, res)
    want = fused_conv3x3(x, w, shift, res, impl="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(fused_conv3x3(x, w, shift, res), got)


@pytest.mark.parametrize("residual", [False, True])
def test_k3_kernel_repeats_bit_for_bit(gen, residual):
    """The two consumer warpgroups write the output tile into a ring slot
    the other reads until its last products: a missing wait there gives
    results that differ between launches.  Layer2's shape, many launches."""
    N, H, W, C = 4, 64, 64, 128
    x = torch.randn(N, H, W, C, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn(3, 3, C, C, generator=gen, device="cuda") * 0.05
    shift = torch.randn(C, generator=gen, device="cuda")
    res = (torch.randn(N, H, W, C, generator=gen, device="cuda").to(
        torch.bfloat16) if residual else None)
    packed = pack_conv3x3_weight(w, shift, torch.bfloat16)
    first = fused_conv3x3(x, None, None, res, packed=packed)
    for _ in range(50):
        assert torch.equal(fused_conv3x3(x, None, None, res, packed=packed),
                           first)


def test_k3_rejects_a_misaligned_operand(gen):
    """TMA takes 16-byte-aligned bases: a view that starts off one raises
    instead of being copied."""
    N, H, W, C = 1, 8, 8, 64
    flat = torch.randn(N * H * W * C + 1, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = flat[1:].view(N, H, W, C)
    w = torch.randn(3, 3, C, C, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="16-byte boundary"):
        fused_conv3x3(x, w, torch.zeros(C, device="cuda"))


def test_basic_block_eval_launches_k3_twice(gen):
    block = BasicBlock(128, 128).cuda().eval()
    x = torch.randn(2, 16, 16, 128, generator=gen, device="cuda")
    ops.reset_launch_counts()
    with torch.no_grad():
        got = block(x)
        assert ops.launch_counts()["fused_conv3x3"] == 2
        with ops.forced_impl("torch"):
            want = block(x)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_kernel_rejects_what_it_does_not_take(gen):
    q = torch.randn(2, 16, 4 * 24, device="cuda")      # D = 24
    with pytest.raises(ValueError, match="head dims"):
        fused_window_attention_packed(q, q, q, 4)
    x = torch.randn(1, 4, 4, 8, device="cuda")          # C = 8
    with pytest.raises(ValueError, match="C % 16"):
        fused_conv3x3(x, torch.randn(3, 3, 8, 8, device="cuda"),
                      torch.zeros(8, device="cuda"))


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _ln(gen, D):
    return 1.0 + 0.1 * _rand(gen, D), 0.1 * _rand(gen, D)


def k2_operands(gen, B, n, H, W, D, C, h, w, embed, tail):
    x, key, val = (_rand(gen, B, H, W, D), _rand(gen, B, n, h, w, D),
                   _rand(gen, B, n, h, w, D))
    w_embed = _rand(gen, H, W, D) if embed else None
    c_embed = _rand(gen, B, n, D) if embed else None
    params = dict(ln_q=_ln(gen, D), ln_k=_ln(gen, D), ln_v=_ln(gen, D))
    for name, (i, o) in (("q", (D, C)), ("k", (D, C)), ("v", (D, C)),
                         ("o", (C, D))):
        params[f"w{name}"] = _rand(gen, i, o, scale=i ** -0.5)
        params[f"b{name}"] = _rand(gen, o, scale=0.1)
    mlp = post_ln = None
    if tail:
        mlp = {"ln": _ln(gen, D), "w1": _rand(gen, D, 2 * D, scale=D ** -0.5),
               "b1": _rand(gen, 2 * D, scale=0.1),
               "w2": _rand(gen, 2 * D, D, scale=(2 * D) ** -0.5),
               "b2": _rand(gen, D, scale=0.1)}
        post_ln = _ln(gen, D)
    return x, w_embed, c_embed, key, val, params, mlp, post_ln


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, n, H, W, D, C, h, w, q_win, k_win, heads, embed, tail, grid, skip)
    (2, 4, 32, 32, 128, 128, 16, 16, (8, 8), (4, 4), 4, True, True, False,
     True),
    (2, 4, 32, 32, 128, 128, 16, 16, (8, 8), (4, 4), 4, False, True, True,
     True),
    # a branch without embed or MLP, no skip, head dim 16
    (3, 2, 16, 24, 32, 32, 8, 12, (8, 8), (4, 4), 2, False, False, False,
     False),
    # head dim 8, ragged query tiles (40 rows a window), grid keys
    (1, 3, 20, 16, 64, 64, 8, 8, (10, 4), (4, 2), 8, True, False, True,
     True),
])
def test_k2_kernel_matches_plain(gen, dtype, case):
    B, n, H, W, D, C, h, w, q_win, k_win, heads, embed, tail, grid, skip = \
        case
    x, we, ce, key, val, params, mlp, post_ln = k2_operands(
        gen, B, n, H, W, D, C, h, w, embed, tail)

    def cast(t):
        return None if t is None else t.to(dtype)

    args = (cast(x), cast(we), cast(ce), cast(key), cast(val), params, q_win,
            k_win, heads, (C // heads) ** -0.5, skip)
    before = fused_cross_view_attention.launches
    got = fused_cross_view_attention(*args, mlp=mlp, post_ln=post_ln,
                                     grid_keys=grid)
    assert fused_cross_view_attention.launches == before + LAUNCHES_PER_CALL
    want = fused_cross_view_attention(*args, mlp=mlp, post_ln=post_ln,
                                      grid_keys=grid, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# chip_smoke.py:K2_CASES: the six FAX branches of a 5-agent frame (B 5,
# 4 cameras, D = C = 128, 4 heads of 32, MLP hidden 256)
# (name, BEV H=W, keys h=w, q_win, k_win, embed, post_ln, grid keys)
K2_PATH_CASES = [
    ("stage0_local", 128, 64, 16, 8, True, False, False),
    ("stage0_grid", 128, 64, 16, 8, False, True, True),
    ("stage1_local", 64, 32, 16, 8, False, False, False),
    ("stage1_grid", 64, 32, 16, 8, False, True, True),
    ("stage2_local", 32, 16, 32, 16, False, False, False),
    ("stage2_grid", 32, 16, 32, 16, False, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K2_PATH_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("B", [5, 1], ids=["corpbevt", "sinbevt_opv2v"])
def test_k2_kernel_matches_plain_at_the_path_shapes(gen, dtype, case, B):
    """B 5: CorpBEVT's agents; B 1: one SinBEVT-OPV2V vehicle, which
    repeats bit for bit in f32 too."""
    _, H, h, q_win, k_win, embed, post, grid = case
    n, D, heads = 4, 128, 4
    x, we, ce, key, val, params, mlp, post_ln = k2_operands(
        gen, B, n, H, H, D, D, h, h, embed, True)
    assert kernel_path(dtype, D, D, heads, 2 * D, n if embed else 1) == (
        "wgmma" if dtype == torch.bfloat16 else "scalar")

    def cast(t):
        return None if t is None else t.to(dtype)

    args = (cast(x), cast(we), cast(ce), cast(key), cast(val), params,
            (q_win, q_win), (k_win, k_win), heads, (D // heads) ** -0.5, True)
    kw = dict(mlp=mlp, post_ln=post_ln if post else None, grid_keys=grid)
    before = fused_cross_view_attention.launches
    got = fused_cross_view_attention(*args, **kw)
    assert fused_cross_view_attention.launches == before + LAUNCHES_PER_CALL
    want = fused_cross_view_attention(*args, **kw, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, H, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if dtype == torch.bfloat16 or B == 1:
        assert torch.equal(fused_cross_view_attention(*args, **kw), got)


# K1 on the SinBEVT paths, head dim 32: (G, Tq, Tk, heads, bias).
# chip_smoke.py:K1_NUSC_CASES, the stock path of a nuScenes frame (100 and
# 625 are ragged query windows), then K1_SINBEVT_CASES, one SinBEVT-OPV2V
# vehicle's FAX windows (stage 0 local and grid, stage 1, stage 2) and its
# self-attention with its relative-position bias
K1_SINBEVT_SHAPES = [(100, 600, 432, 1, False), (100, 100, 432, 1, False),
                     (25, 100, 432, 2, False), (1, 625, 2520, 4, False),
                     (64, 1024, 256, 4, False), (64, 256, 256, 4, False),
                     (16, 256, 256, 4, False), (1, 1024, 1024, 4, False),
                     (1, 1024, 1024, 4, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,Tq,Tk,H,bias", K1_SINBEVT_SHAPES)
def test_k1_kernel_matches_plain_at_the_sinbevt_shapes(gen, dtype, G, Tq,
                                                       Tk, H, bias):
    q = (_rand(gen, G, Tq, H * 32) * 32 ** -0.5).to(dtype)
    k, v = _rand(gen, G, Tk, H * 32).to(dtype), _rand(gen, G, Tk, H * 32).to(
        dtype)
    b = _rand(gen, Tq, H * Tk) * 0.5 if bias else None
    before = fused_window_attention_packed.launches
    got = fused_window_attention_packed(q, k, v, H, bias_flat=b)
    assert fused_window_attention_packed.launches == before + 1
    want = fused_window_attention_packed(q, k, v, H, bias_flat=b,
                                         impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(fused_window_attention_packed(q, k, v, H, bias_flat=b),
                       got)


# chip_smoke.py:K2_NUSC_CASES: the six branches of a SinBEVT-nuScenes frame
# (B 1, 6 cameras, head dim 32, MLP hidden 2 D): (name, BEV H=W, keys (h, w),
# q_win, k_win, D = C, heads, embed, post_ln, grid keys, route in bf16)
K2_NUSC_CASES = [
    ("stage0_local", 100, (60, 120), (10, 10), (6, 12), 32, 1, True, False,
     False, "wgmma"),
    ("stage0_grid", 100, (60, 120), (10, 10), (6, 12), 32, 1, False, True,
     True, "wgmma"),
    ("stage1_local", 50, (30, 60), (10, 10), (6, 12), 64, 2, False, False,
     False, "wgmma"),
    ("stage1_grid", 50, (30, 60), (10, 10), (6, 12), 64, 2, False, True,
     True, "wgmma"),
    ("stage2_local", 25, (14, 30), (25, 25), (14, 30), 128, 4, False, False,
     False, "wgmma"),
    ("stage2_grid", 25, (14, 30), (25, 25), (14, 30), 128, 4, False, True,
     True, "wgmma"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K2_NUSC_CASES, ids=lambda c: c[0])
def test_k2_kernel_matches_plain_at_the_nuscenes_shapes(gen, dtype, case):
    _, H, (h, w), q_win, k_win, D, heads, embed, post, grid, route = case
    B, n = 1, 6
    x, we, ce, key, val, params, mlp, post_ln = k2_operands(
        gen, B, n, H, H, D, D, h, w, embed, True)
    assert kernel_path(dtype, D, D, heads, 2 * D, n if embed else 1) == (
        route if dtype == torch.bfloat16 else "scalar")

    def cast(t):
        return None if t is None else t.to(dtype)

    args = (cast(x), cast(we), cast(ce), cast(key), cast(val), params,
            q_win, k_win, heads, (D // heads) ** -0.5, True)
    kw = dict(mlp=mlp, post_ln=post_ln if post else None, grid_keys=grid)
    before = fused_cross_view_attention.launches
    got = fused_cross_view_attention(*args, **kw)
    assert fused_cross_view_attention.launches == before + LAUNCHES_PER_CALL
    want = fused_cross_view_attention(*args, **kw, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, H, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(fused_cross_view_attention(*args, **kw), got)


def test_k2_rejects_what_it_does_not_take(gen):
    x, we, ce, key, val, params, mlp, post_ln = k2_operands(
        gen, 1, 4, 32, 32, 128, 128, 16, 16, True, True)
    b = [t.to(torch.bfloat16) for t in (x, we, ce, key, val)]
    with pytest.raises(ValueError, match="does not take"):   # head dim 128/5
        fused_cross_view_attention(*b, params, (8, 8), (4, 4), 5, 0.1)
    with pytest.raises(ValueError, match="matching window grids"):
        fused_cross_view_attention(*b, params, (8, 8), (8, 8), 4, 0.1)
    with pytest.raises(ValueError, match="takes"):
        fused_cross_view_attention(*(t.half() for t in b), params, (8, 8),
                                   (4, 4), 4, 0.1)
    with pytest.raises(ValueError, match="boundary"):       # TMA bases
        xs = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                         device="cuda")[1:].view(x.shape)
        xs.copy_(b[0])
        fused_cross_view_attention(xs, *b[1:], params, (8, 8), (4, 4), 4,
                                   0.1)


def k4_operands(gen, B, L, H, W, D, w, heads, depth, mlp):
    T = L * w * w

    def layer():
        return {"ln_a": _ln(gen, D), "wqkv": _rand(gen, D, 3 * D,
                                                    scale=D ** -0.5),
                "wout": _rand(gen, D, D, scale=D ** -0.5), "ln_f": _ln(gen, D),
                "w1": _rand(gen, D, mlp, scale=D ** -0.5),
                "b1": _rand(gen, mlp, scale=0.1),
                "w2": _rand(gen, mlp, D, scale=mlp ** -0.5),
                "b2": _rand(gen, D, scale=0.1)}

    layers = [(layer(), layer()) for _ in range(depth)]
    bias = _rand(gen, depth, 2, T, heads * T, scale=0.5)
    head = {"ln": _ln(gen, D), "w": _rand(gen, D, D, scale=D ** -0.5),
            "b": _rand(gen, D, scale=0.1)}
    return _rand(gen, B, L, H, W, D), layers, bias, head


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, L, H, W, D, window, heads, depth, mlp, mask, mean_over_valid)
    (1, 5, 32, 32, 128, 8, 4, 3, 256, "random", False),   # CorpBEVT
    (2, 3, 16, 16, 64, 4, 2, 2, 128, "mostly_masked", True),
    (2, 4, 16, 8, 32, 4, 4, 1, 32, None, True),            # head dim 8
    (1, 2, 8, 24, 32, 4, 2, 2, 48, "random", False),       # head dim 16
])
def test_k4_kernel_matches_plain(gen, dtype, case):
    B, L, H, W, D, w, heads, depth, mlp, mask_kind, valid = case
    x, layers, bias, head = k4_operands(gen, B, L, H, W, D, w, heads, depth,
                                        mlp)
    mask = None
    if mask_kind is not None:
        mask = (torch.rand(B, L, H, W, generator=gen, device="cuda")
                > 0.3).float()
        mask[:, 0] = 1.0
        if mask_kind == "mostly_masked":
            # window (0, 0) and grid cell (0, 0) keep one live key each
            mask[:, :, :w, :w] = 0.0
            mask[:, :, ::H // w, ::W // w] = 0.0
            mask[:, 0, 0, 0] = 1.0
    agent_mask = torch.ones(B, L, device="cuda")
    agent_mask[:, -1] = 0.0
    args = (x.to(dtype), mask, agent_mask, bias, layers, head, w, heads, valid)
    before = fused_swap_fusion.launches
    got = fused_swap_fusion(*args)
    assert fused_swap_fusion.launches == before + launches_per_call(
        depth, k4_kernel_path(D, heads, mlp, dtype))
    want = fused_swap_fusion(*args, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **K4_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    # (B, L, H, W, D, window, heads, depth, mlp, mask, mean_over_valid)
    (1, 3, 16, 16, 128, 8, 4, 2, 256, "random", False),
    (1, 3, 16, 16, 256, 8, 8, 2, 512, "random", True),
    (2, 3, 16, 24, 64, 4, 2, 1, 128, "mostly_masked", True),
    (2, 4, 16, 8, 64, 4, 8, 1, 64, None, True),            # head dim 8
    (1, 2, 8, 24, 64, 4, 4, 2, 192, "random", False),      # head dim 16
    (1, 5, 24, 40, 256, 8, 8, 1, 512, "fully_masked", False),
    # SECOND's widths: D 512, 16 heads, mlp 256, window 4 (bf16: the D 512
    # route of ops/fused_swap_fusion.py:wide_plan)
    (1, 3, 16, 20, 512, 4, 16, 1, 256, "random", False),
])
def test_k6_kernel_matches_plain(gen, dtype, case):
    B, L, H, W, D, w, heads, depth, mlp, mask_kind, valid = case
    x, layers, bias, head = k4_operands(gen, B, L, H, W, D, w, heads, depth,
                                        mlp)
    mask = None
    if mask_kind is not None:
        mask = (torch.rand(B, L, H, W, generator=gen, device="cuda")
                > 0.3).float()
        mask[:, 0] = 1.0
        if mask_kind == "mostly_masked":
            mask[:, :, :w, :w] = 0.0
            mask[:, :, ::H // w, ::W // w] = 0.0
            mask[:, 0, 0, 0] = 1.0
        if mask_kind == "fully_masked":
            # no live key in window (0, 0): finite and uniform, as in K1
            mask[:, :, :w, :w] = 0.0
    agent_mask = torch.ones(B, L, device="cuda")
    agent_mask[:, -1] = 0.0
    args = (x.to(dtype), mask, agent_mask, bias, layers, head, w, heads, valid)
    before = fused_swap_fusion_streaming.launches
    got = fused_swap_fusion_streaming(*args)
    assert fused_swap_fusion_streaming.launches == before + 2 * depth
    want = fused_swap_fusion_streaming(*args, impl="torch")
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **K4_TOL[dtype])


@pytest.mark.parametrize("case", ["masked", "mean_over_valid",
                                  "fully_masked_window"])
def test_k6_wgmma_matches_plain_at_the_lidar_shape(gen, case):
    """K6's wgmma route at the cooperative-LiDAR map (1, 5, 96, 176, 256), 8
    heads, window 8, depth 2, mlp 512, bf16: against the plain version
    within K4_TOL, and a second call bit for bit."""
    B, L, H, W, D, w, heads, depth, mlp = 1, 5, 96, 176, 256, 8, 8, 2, 512
    x, layers, bias, head = k4_operands(gen, B, L, H, W, D, w, heads, depth,
                                        mlp)
    mask = (torch.rand(B, L, H, W, generator=gen, device="cuda")
            > 0.3).float()
    mask[:, 0] = 1.0
    if case == "fully_masked_window":
        mask[:, :, :w, :w] = 0.0
    agent_mask = torch.ones(B, L, device="cuda")
    agent_mask[:, -1] = 0.0
    args = (x.to(torch.bfloat16), mask, agent_mask, bias, layers, head, w,
            heads, case == "mean_over_valid")
    before = fused_swap_fusion_streaming.launches
    got = fused_swap_fusion_streaming(*args)
    again = fused_swap_fusion_streaming(*args)
    assert fused_swap_fusion_streaming.launches == before + 4 * depth
    want = fused_swap_fusion_streaming(*args, impl="torch")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    torch.testing.assert_close(got.float(), want.float(),
                               **K4_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 32, 32, 256), (20, 16, 16, 512)])
@pytest.mark.parametrize("residual", [False, True])
def test_k7_scale_fold_equals_plain_at_the_trunk_shapes(gen, dtype, shape,
                                                         residual):
    """K7 on wgmma at the two trunk shapes of the int8 mode: the wrapper's
    call (one absmax into a zeroed slot, one K7) and the kernel on a slot
    that folds its own output's |max| are bit-equal to the plain version
    (act_scale's max-reduce), the folded slot to the plain fold of the
    output, and a repeat to the first call."""
    N, H, W, C = shape
    assert int8_tile_plan(H, W, C).path == "wgmma"
    x = torch.randn(N, H, W, C, generator=gen, device="cuda").relu().to(dtype)
    w = torch.randn(3, 3, C, C, generator=gen, device="cuda") * (
        2 / (9 * C)) ** 0.5
    shift = torch.randn(C, generator=gen, device="cuda") * 0.1
    res = (torch.randn(N, H, W, C, generator=gen, device="cuda").to(dtype)
           if residual else None)
    packed = pack_int8_weight(w, shift)
    ops.reset_launch_counts()
    got = fused_conv3x3_int8(x, None, None, res, packed=packed)
    counts = ops.launch_counts()
    assert counts["fused_conv3x3_int8"] == 1 and counts["int8_absmax"] == 1
    want = fused_conv3x3_int8(x, None, None, res, packed=packed,
                              impl="torch")
    slot = int8_absmax(x, new_amax_slots(1, x.device))
    out_slot = new_amax_slots(1, x.device)
    folded = _launch_int8(x, packed, slot, res, True, out_slot)
    again = _launch_int8(x, packed, slot, res, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(folded, want)
    assert torch.equal(again, want)
    assert torch.equal(out_slot, fold_amax_(new_amax_slots(1, x.device),
                                            want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 32, 32, 256), (20, 16, 16, 512),
                                   (3, 5, 7, 8), (1, 8)])
def test_int8_absmax_equals_plain(gen, dtype, shape):
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype) * 3
    for start in (0.0, 1e3):      # a slot that already holds a larger max
        init = torch.tensor([start], device="cuda").view(torch.int32)
        got = int8_absmax(x, init.clone())
        want = fold_amax_(init.clone(), x)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def test_fused_kernels_reject_what_they_do_not_take(gen):
    x, we, ce, key, val, params, _, _ = k2_operands(
        gen, 1, 2, 16, 16, 64, 64, 8, 8, True, False)
    with pytest.raises(ValueError, match="K2 does not take"):   # head dim 64
        fused_cross_view_attention(x, we, ce, key, val, params, (8, 8),
                                   (4, 4), 1, 1.0)
    x, layers, bias, head = k4_operands(gen, 1, 3, 12, 12, 32, 3, 2, 1, 32)
    with pytest.raises(ValueError, match="K4 does not take"):
        fused_swap_fusion(x, None, None, bias, layers, head, 3, 2)
    with pytest.raises(ValueError, match="K6 does not take"):
        fused_swap_fusion_streaming(x, None, None, bias, layers, head, 3, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 32, 32, 256, 256),      # layer3: 4 image rows a block
    (2, 16, 16, 512, 512),      # layer4: 8 image rows a block
    (2, 9, 7, 64, 24),          # ragged: idle pixel slots, O below a block
    (1, 3, 128, 64, 64),        # one image row a block
    (1, 5, 48, 128, 136),       # rows that do not fill 128 slots, two blocks
])
@pytest.mark.parametrize("residual,relu", [(False, True), (True, True),
                                           (True, False)])
def test_k7_kernel_equals_plain(gen, dtype, shape, residual, relu):
    N, H, W, C, O = shape
    x = torch.randn(N, H, W, C, generator=gen, device="cuda").to(dtype)
    w = torch.randn(3, 3, C, O, generator=gen, device="cuda") * 0.05
    shift = torch.randn(O, generator=gen, device="cuda") * 0.1
    res = (torch.randn(N, H, W, O, generator=gen, device="cuda").to(dtype)
           if residual else None)
    before = fused_conv3x3_int8.launches
    got = fused_conv3x3_int8(x, w, shift, res, relu=relu)
    assert fused_conv3x3_int8.launches == before + 1
    want = fused_conv3x3_int8(x, w, shift, res, relu=relu, impl="torch")
    assert fused_conv3x3_int8.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert torch.equal(got, want), float((got.float() - want.float())
                                         .abs().max())


def test_basic_block_eval_launches_k7_under_the_int8_switch(gen, monkeypatch):
    wide = BasicBlock(256, 256).cuda().eval()
    narrow = BasicBlock(128, 128).cuda().eval()
    x = torch.randn(2, 16, 16, 256, generator=gen, device="cuda").relu()
    monkeypatch.setenv("COBEVT_INT8", "1")
    ops.reset_launch_counts()
    with torch.no_grad():
        got = wide(x)
        narrow(x[..., :128].contiguous())
        counts = ops.launch_counts()
        assert counts["fused_conv3x3_int8"] == 2
        assert counts["fused_conv3x3"] == 2
        with ops.forced_impl("torch"):
            want = wide(x)
    assert torch.equal(got, want)


def test_k7_rejects_what_it_does_not_take(gen):
    x = torch.randn(1, 4, 4, 96, device="cuda")
    with pytest.raises(ValueError, match="C % 64"):
        fused_conv3x3_int8(x, torch.randn(3, 3, 96, 64, device="cuda"),
                           torch.zeros(64, device="cuda"))
    x = torch.randn(1, 2, 256, 64, device="cuda")
    with pytest.raises(ValueError, match="W <= 128"):
        fused_conv3x3_int8(x, torch.randn(3, 3, 64, 64, device="cuda"),
                           torch.zeros(64, device="cuda"))


@pytest.mark.parametrize("shape", [
    (2, 128, 128, 64, 64),      # layer1: one image row and 64 channels a block
    (2, 9, 7, 64, 24),          # ragged
    (1, 16, 16, 128, 136),      # two 128-channel blocks, the second ragged
])
@pytest.mark.parametrize("case", ["interior", "interior_saturating",
                                  "interior_residual", "exit_bf16_residual",
                                  "exit_f32", "no_relu"])
def test_s8_chain_kernel_equals_plain(gen, shape, case):
    N, H, W, C, O = shape
    x = torch.randn(N, H, W, C, generator=gen, device="cuda")
    res = torch.randn(N, H, W, O, generator=gen, device="cuda").abs()
    w = torch.randn(3, 3, C, O, generator=gen, device="cuda") * 0.1
    t = torch.randn(O, generator=gen, device="cuda") * 0.05
    xq, sx = quantize_dynamic(x)
    rq, rs = quantize_dynamic(res)
    p = pack_s8_weight(w, t)
    kwargs = dict(relu=case != "no_relu", with_sat=True)
    if "residual" in case:
        kwargs.update(residual_q=rq, residual_scale=rs)
    if case.startswith("exit"):
        kwargs["out_dtype"] = (torch.float32 if case == "exit_f32"
                               else torch.bfloat16)
    else:
        # a fifth of the range at "saturating": many values clip
        kwargs["out_scale"] = sx * (0.2 if "saturating" in case else 2.0)
    before = conv3x3_s8.launches
    got, sat = conv3x3_s8(xq, sx, p.w_q, p.s_w, p.shift, wt=p.wt, **kwargs)
    assert conv3x3_s8.launches == before + 1
    want, want_sat = conv3x3_s8(xq, sx, p.w_q, p.s_w, p.shift, impl="torch",
                                **kwargs)
    assert conv3x3_s8.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert sat.item() == want_sat.item()
    assert (sat.item() > 0.05) == ("saturating" in case)
    # the weight operand is built from w_q when it is not handed in
    kwargs["with_sat"] = False
    assert torch.equal(conv3x3_s8(xq, sx, p.w_q, p.s_w, p.shift, **kwargs),
                       got)


# chip_smoke.py:S8_CASES: the three layer1 convs of an int8 frame on the
# strip kernel, and a height its strips do not divide at a width of 96
@pytest.mark.parametrize("shape,case", [
    ((20, 128, 128, 64), "conv1"),
    ((20, 128, 128, 64), "conv2"),
    ((20, 128, 128, 64), "conv2_exit"),
    ((20, 45, 96, 64), "conv2"),
])
def test_s8_strip_kernel_equals_plain_at_the_chain_shapes(gen, shape, case):
    N, H, W, C = shape
    assert s8_plan(N, H, W, C, C, torch.cuda.get_device_properties(0)
                   .multi_processor_count).path == "strip"
    xq, sx = quantize_dynamic(
        torch.randn(N, H, W, C, generator=gen, device="cuda").relu())
    rq, rs = quantize_dynamic(
        torch.randn(N, H, W, C, generator=gen, device="cuda").relu())
    w = torch.randn(3, 3, C, C, generator=gen, device="cuda") * (
        2 / (9 * C)) ** 0.5
    p = pack_s8_weight(w, torch.randn(C, generator=gen, device="cuda") * 0.1)
    kwargs = dict(with_sat=True, out_dtype=torch.bfloat16)
    if case != "conv1":
        kwargs.update(residual_q=rq, residual_scale=rs)
    if case != "conv2_exit":
        # half the range: some values clip
        kwargs["out_scale"] = sx * 0.5
    before = conv3x3_s8.launches
    got, sat = conv3x3_s8(xq, sx, p.w_q, p.s_w, p.shift, wt=p.wt, **kwargs)
    assert conv3x3_s8.launches == before + 1
    want, want_sat = conv3x3_s8(xq, sx, p.w_q, p.s_w, p.shift, impl="torch",
                                **kwargs)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert sat.item() == want_sat.item()
    assert (sat.item() > 0) == (case != "conv2_exit")


# chip_smoke.py:K4_CASES: CorpBEVT's encoder (1, 5, 32, 32, 128) in bf16 on
# the wgmma route: (mask, mean_over_valid, live agents)
@pytest.mark.parametrize("masked,valid,live", [
    (True, False, [1, 1, 1, 0, 0]),
    (True, True, [1, 1, 1, 0, 0]),
    (False, False, [1, 1, 1, 0, 0]),
    (True, True, [1, 1, 0, 1, 1]),       # agent 2 dead between live ones
])
def test_k4_wgmma_route_matches_plain_at_corpbevt(gen, masked, valid, live):
    B, L, H, W, D, w, heads, depth, mlp = 1, 5, 32, 32, 128, 8, 4, 3, 256
    assert k4_kernel_path(D, heads, mlp, torch.bfloat16) == "wgmma"
    x, layers, bias, head = k4_operands(gen, B, L, H, W, D, w, heads, depth,
                                        mlp)
    agent_mask = torch.tensor([live], dtype=torch.float32, device="cuda")
    mask = None
    if masked:
        mask = (torch.rand(B, L, H, W, generator=gen, device="cuda")
                > 0.3).float() * agent_mask[:, :, None, None]
        mask[:, 0] = 1.0
    args = (x.bfloat16(), mask, agent_mask, bias, layers, head, w, heads,
            valid)
    before = fused_swap_fusion.launches
    got = fused_swap_fusion(*args)
    assert fused_swap_fusion.launches == before + launches_per_call(
        depth, "wgmma")
    want = fused_swap_fusion(*args, impl="torch")
    torch.cuda.synchronize()
    assert got.shape == (B, H, W, D) and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               **K4_TOL[torch.bfloat16])
    # no atomics: a second call gives the same bits
    assert torch.equal(fused_swap_fusion(*args), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_int8_region_equals_its_plain_versions(gen, monkeypatch, dtype):
    """ResNet-34 under COBEVT_INT8=1: layer1 as 6 launches of the chain's
    conv, layer3 and layer4 as 14 K7 launches, layer2 as 6 K3; the kernels'
    integers are the plain versions', so the first stage is equal and the
    later ones differ only by K3's and cuDNN's float sums."""
    torch.manual_seed(0)
    trunk = ResNetTrunk(34).cuda().to(dtype).eval()
    x = torch.randn(2, 128, 128, 3, generator=gen, device="cuda").to(dtype)
    monkeypatch.setenv("COBEVT_INT8", "1")
    trunk.collect_int8_sat = True
    ops.reset_launch_counts()
    with torch.no_grad():
        got = trunk(x)
        counts = ops.launch_counts()
        sats = [float(s) for s in trunk.int8_sat_fracs]
        with ops.forced_impl("torch"):
            want = trunk(x)
            want_sats = [float(s) for s in trunk.int8_sat_fracs]
    assert counts["conv3x3_s8"] == 6 and counts["fused_conv3x3_int8"] == 14
    assert counts["fused_conv3x3"] == 6
    assert torch.equal(got[0], want[0]) and sats == want_sats
    for g, w in zip(got[1:], want[1:]):
        scale = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= 0.05 * scale


def _assert_sums_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all()
        scale = float(w.abs().max()) + 1e-9
        assert float((g - w).abs().max()) <= 1e-4 * scale


def _spy_routes(monkeypatch):
    """The routes the wrappers launch, in order."""
    taken = []
    for route in ("cuda", "triton"):
        real = getattr(bn_stats, f"_launch_{route}")

        def spy(*args, real=real, route=route):
            taken.append(route)
            return real(*args)
        monkeypatch.setattr(bn_stats, f"_launch_{route}", spy)
    return taken


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5 * 128 * 128, 128), (40_000, 144),
                                   (1000, 336), (7, 192), (33, 8),
                                   (513, 100)]
                         + [s for s, _ in BN_SHAPES])
@pytest.mark.parametrize("s", [-1e30, 0.25])
def test_k9_k10_kernels_match_plain(gen, monkeypatch, dtype, shape, s):
    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    taken = _spy_routes(monkeypatch)
    before = bn_stats_fwd.launches, bn_stats_bwd.launches
    routes_before = dict(bn_stats.route_launches)
    fwd, bwd = bn_stats_fwd(x, s), bn_stats_bwd(dy, x, s)
    # bf16 rows of 200 bytes are no whole number of 16-byte vectors
    route = "triton" if shape == (513, 100) and dtype == torch.bfloat16 \
        else "cuda"
    assert taken == [route, route]
    # the per-route count that chip_smoke.py reads moves with the route
    assert {k: n - routes_before[k]
            for k, n in bn_stats.route_launches.items()} == {
        "cuda": 2 * (route == "cuda"), "triton": 2 * (route == "triton")}
    assert (bn_stats_fwd.launches, bn_stats_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    _assert_sums_close(fwd, bn_stats_fwd(x, s, impl="torch"))
    _assert_sums_close(bwd, bn_stats_bwd(dy, x, s, impl="torch"))
    assert (bn_stats_fwd.launches, bn_stats_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    # no atomics: a second run gives the same bits, both sums of both
    for first, again in ((fwd, bn_stats_fwd(x, s)),
                         (bwd, bn_stats_bwd(dy, x, s))):
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


def test_k9_k10_misaligned_bases_take_triton(gen, monkeypatch):
    buf = torch.randn(2 * 4096 * 144 + 8, generator=gen,
                      device="cuda").bfloat16()
    x = buf[1:4096 * 144 + 1].view(4096, 144)
    dy = buf[4096 * 144 + 8:2 * 4096 * 144 + 8].view(4096, 144)
    taken = _spy_routes(monkeypatch)
    fwd, bwd = bn_stats_fwd(x, 0.25), bn_stats_bwd(dy, x, 0.25)
    fwd2 = bn_stats_fwd(dy, 0.25)
    assert taken == ["triton", "triton", "cuda"]
    torch.cuda.synchronize()
    _assert_sums_close(fwd, bn_stats_fwd(x, 0.25, impl="torch"))
    _assert_sums_close(bwd, bn_stats_bwd(dy, x, 0.25, impl="torch"))
    _assert_sums_close(fwd2, bn_stats_fwd(dy, 0.25, impl="torch"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_k10_threshold_as_a_device_tensor(gen, dtype):
    x = torch.randn(40_000, 144, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(40_000, 144, generator=gen, device="cuda").to(dtype)
    # 0.3001 rounds to 0.30078125 in bf16: the kernel must compare with
    # that, whether s comes as a number or as an f32 tensor on the card
    for s in (0.3001, -1e30):
        st = torch.tensor(s, device="cuda")
        for a, b in ((bn_stats_fwd(x, s), bn_stats_fwd(x, st)),
                     (bn_stats_bwd(dy, x, s), bn_stats_bwd(dy, x, st))):
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        _assert_sums_close(bn_stats_fwd(x, st),
                           bn_stats_fwd(x, s, impl="torch"))
        _assert_sums_close(bn_stats_bwd(dy, x, st),
                           bn_stats_bwd(dy, x, s, impl="torch"))


def test_k9_k10_on_two_streams(gen):
    # each call launches on its caller's current stream with its own
    # partial rows: calls on two streams at once give what one stream gives
    x = torch.randn(322_560, 192, generator=gen, device="cuda").bfloat16()
    dy = torch.randn(322_560, 192, generator=gen, device="cuda").bfloat16()
    want = bn_stats_fwd(x, -1e30), bn_stats_bwd(dy, x, -1e30)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for _ in range(3):
        here = bn_stats_fwd(x, -1e30), bn_stats_bwd(dy, x, -1e30)
        with torch.cuda.stream(side):
            there = bn_stats_fwd(x, -1e30), bn_stats_bwd(dy, x, -1e30)
        torch.cuda.synchronize()
        for got in (here, there):
            for g, w in zip(got, want):
                assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k9_k10_propagate_nan(gen, dtype):
    R, C = 5000, 144
    x = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(R, C, generator=gen, device="cuda").to(dtype)
    x[1234, 5] = float("nan")
    dy[4321, 77] = float("nan")
    for got, want in ((bn_stats_fwd(x, 0.25), bn_stats_fwd(
                          x, 0.25, impl="torch")),
                      (bn_stats_bwd(dy, x, 0.25), bn_stats_bwd(
                          dy, x, 0.25, impl="torch"))):
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan()) and bool(w.isnan().any())
            ok = ~w.isnan()
            scale = float(w[ok].abs().max())
            assert float((g[ok] - w[ok]).abs().max()) <= 1e-4 * scale
    # a NaN threshold makes every sum NaN, as torch.maximum does
    assert bool(bn_stats_fwd(x, float("nan"))[0].isnan().all())


def test_k9_k10_reject_what_they_do_not_take(gen):
    x = torch.randn(8, 4, 16, device="cuda")
    with pytest.raises(ValueError, match=r"\(R, C\)"):
        bn_stats_fwd(x, 0.0)
    x = torch.randn(16, 8, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        bn_stats_bwd(x, x.t().contiguous().t(), 0.0)
