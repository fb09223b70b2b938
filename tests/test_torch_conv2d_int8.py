"""K7 (the int8 fused 3x3 conv) of the port against the JAX package.

The same numpy inputs go through ``cobevt_tpu.ops.conv2d`` (its quantizers,
its XLA twin ``_xla_reference_int8`` and, at one small shape, the Pallas body
in interpret mode) and through the port's plain version.  Quantized weights,
weight scales and the activation scale must be EQUAL (same f32 operations in
the same order); outputs agree within 1e-6 of the largest value in f32 (the
integers are equal, the f32 epilogue may contract a multiply-add on one
side) and within one bf16 ulp (at most 2^-7 of the value, plus 1e-6 of the
largest value) in bf16.  The bf16 case calls the JAX twin op by op: inside
one ``jit`` XLA turns the scales' division by the constant 127 into a
multiplication by its reciprocal, so a scale moves in its last bit (12 of the
256 weight scales of that case) and a weight that sits at a tie rounds the
other way (1 of 589,824), which moves that output channel's values.  The
port keeps the division that the source states.  Also the dispatch:
``COBEVT_INT8=1`` sends a stride-1 eval block with both channel axes >= 256
to K7 and leaves C 128 on K3.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.ops import conv2d as jax_conv2d
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.nn import layers as port_layers
from cobevt_tpu_torch.nn.layers import BasicBlock
from cobevt_tpu_torch.ops import conv2d as port_conv2d
from cobevt_tpu_torch.ops.conv2d import (
    act_scale,
    conv3x3_int8_reference,
    conv3x3_s32,
    fused_conv3x3,
    fused_conv3x3_int8,
    int8_kernel_accepts,
    pack_int8_weight,
    quantize_weight,
)


def _data(shape, residual, seed=0, dtype=np.float32):
    N, H, W, C, O = shape
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(N, H, W, C)).astype(dtype)
    w = (rng.randn(3, 3, C, O) * 0.05).astype(np.float32)
    b = (rng.randn(O) * 0.1).astype(np.float32)
    r = rng.randn(N, H, W, O).astype(dtype) if residual else None
    return x, w, b, r


def _assert_output_close(got, want, bf16=False):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    tol = 1e-6 * scale + (2.0 ** -7 * np.abs(want) if bf16 else 0.0)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize("shape", [(3, 3, 256, 256), (3, 3, 64, 32)])
def test_quantize_weight_equals_jax(shape):
    rng = np.random.RandomState(1)
    w = (rng.randn(*shape) * 0.05).astype(np.float32)
    w[..., 3] = 0.0                       # a dead channel: the 1e-12 clamp
    w_q, s_w = quantize_weight(torch.from_numpy(w))
    jw_q, js_w = jax_conv2d._quantize_weight(jnp.asarray(w))
    assert w_q.dtype == torch.int8 and s_w.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(s_w.numpy(), np.asarray(js_w))
    assert s_w[3] == np.float32(1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_act_scale_equals_jax(dtype):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 7, 16).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    s = act_scale(tx)
    assert s.dtype == torch.float32 and s.dim() == 0
    assert s.item() == float(jax_conv2d._act_scale(jx))
    assert act_scale(torch.zeros(4)).item() == np.float32(1e-12)


def _activations_at_ties():
    """f32 activations for which ``x * (1 / s_a)`` and ``x / s_a`` round to
    different integers somewhere: found by a seeded search."""
    rng = np.random.RandomState(0)
    for _ in range(200):
        top = np.float32(rng.uniform(1, 8))
        s_a = top / np.float32(127.0)
        x = rng.uniform(0, top, 1 << 16).astype(np.float32)
        flips = np.round(x * (np.float32(1.0) / s_a)) != np.round(x / s_a)
        if flips.any():
            picked = np.concatenate([[top], x[flips], x[:63 - flips.sum()]])
            return picked[:64].reshape(1, 1, 1, 64)
    raise AssertionError("no tie found")


def test_activations_are_multiplied_by_the_reciprocal_scale():
    """K7 quantizes as ``x * (1 / s_a)``, the int8 chain as ``x / s``: on
    activations where the two round differently the port follows the JAX
    function at each site."""
    from cobevt_tpu.ops import int8_chain as jax_chain
    from cobevt_tpu_torch.ops.int8_chain import quantize_dynamic
    x = _activations_at_ties()
    w = np.zeros((3, 3, 64, 8), np.float32)
    w[1, 1] = np.eye(64, 8)               # the centre tap copies 8 channels
    shift = np.zeros(8, np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    s_a = act_scale(tx)
    got = fused_conv3x3_int8(tx, torch.from_numpy(w), torch.from_numpy(shift))
    jw_q, js_w = jax_conv2d._quantize_weight(jnp.asarray(w))
    want = jax_conv2d._xla_reference_int8(
        jx, jw_q, js_w, jax_conv2d._act_scale(jx), jnp.asarray(shift), None,
        True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the recovered integers are the multiply's, not the divide's
    ticks = torch.round(got[0, 0, 0] / s_a).numpy()
    mul = np.round(x.ravel()[:8] * (np.float32(1.0) / s_a.numpy()))
    div = np.round(x.ravel()[:8] / s_a.numpy())
    assert (mul != div).any() and np.array_equal(ticks, mul)
    xq, s = quantize_dynamic(tx)
    jq, js = jax_chain.quantize_dynamic(jx)
    assert s.item() == float(js)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jq))


def test_the_two_epsilon_forms_are_kept_apart():
    """Tiny tensors show which form a site uses: K7's scales are clamped
    from below at 1e-12, the chain's have 1e-12 added."""
    from cobevt_tpu.ops import int8_chain as jax_chain
    from cobevt_tpu_torch.ops.int8_chain import (
        quantize_dynamic,
        quantize_kernel_per_out,
    )
    rng = np.random.RandomState(7)
    x = (rng.rand(2, 3, 3, 16) * 1e-6).astype(np.float32)
    w = (rng.randn(3, 3, 16, 8) * 1e-6).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    clamped, added = act_scale(tx).item(), quantize_dynamic(tx)[1].item()
    assert clamped == float(jax_conv2d._act_scale(jnp.asarray(x)))
    assert added == float(jax_chain.quantize_dynamic(jnp.asarray(x))[1])
    assert added > clamped                # the added 1e-12 shows in f32
    k7_q, k7_s = quantize_weight(tw)
    ch_q, ch_s = quantize_kernel_per_out(tw)
    jk7 = jax_conv2d._quantize_weight(jnp.asarray(w))
    jch = jax_chain.quantize_kernel_per_out(jnp.asarray(w))
    np.testing.assert_array_equal(k7_s.numpy(), np.asarray(jk7[1]))
    np.testing.assert_array_equal(ch_s.numpy(), np.asarray(jch[1]))
    np.testing.assert_array_equal(k7_q.numpy(), np.asarray(jk7[0]))
    np.testing.assert_array_equal(ch_q.numpy(), np.asarray(jch[0]))
    assert (ch_s > k7_s).all()


def test_conv3x3_s32_is_the_integer_convolution():
    rng = np.random.RandomState(3)
    x = rng.randint(-127, 128, (2, 5, 6, 16)).astype(np.int8)
    w = rng.randint(-127, 128, (3, 3, 16, 8)).astype(np.int8)
    x[0, 0, 0], w[0, 0] = 127, 127              # the largest products
    got = conv3x3_s32(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = sum(np.einsum("nhwc,co->nhwo", xp[:, dy:dy + 5, dx:dx + 6],
                         w[dy, dx].astype(np.int64))
               for dy in range(3) for dx in range(3))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="exact"):
        conv3x3_s32(torch.zeros(1, 2, 2, 1088, dtype=torch.int8),
                    torch.zeros(3, 3, 1088, 8, dtype=torch.int8))


@pytest.mark.parametrize("shape", [
    (2, 16, 16, 256, 256),    # layer3-like (the int8 gate's domain)
    (1, 8, 16, 384, 256),     # non-square, O != C
])
@pytest.mark.parametrize("residual,relu", [(False, True), (True, True),
                                           (True, False)])
def test_k7_plain_matches_jax_twin(shape, residual, relu):
    x, w, b, r = _data(shape, residual)
    got = fused_conv3x3_int8(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if r is None else torch.from_numpy(r), relu=relu)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    jw_q, js_w = jax_conv2d._quantize_weight(jw)
    want = jax_conv2d._xla_reference_int8(
        jx, jw_q, js_w, jax_conv2d._act_scale(jx), jnp.asarray(b),
        None if r is None else jnp.asarray(r), relu)
    assert got.dtype == torch.float32
    _assert_output_close(got, want)


@pytest.mark.parametrize("residual,relu", [(False, True), (True, True),
                                           (True, False)])
def test_k7_plain_matches_the_pallas_body_in_interpret_mode(residual, relu):
    x, w, b, r = _data((2, 8, 8, 256, 256), residual, seed=4)
    got = fused_conv3x3_int8(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if r is None else torch.from_numpy(r), relu=relu)
    want = jax_conv2d.fused_conv3x3_int8(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if r is None else jnp.asarray(r), relu=relu, interpret=True)
    _assert_output_close(got, want)


@pytest.mark.parametrize("residual", [False, True])
def test_k7_plain_matches_jax_in_bf16(residual):
    x, w, b, r = _data((2, 8, 8, 256, 256), residual, seed=5)
    tx = torch.from_numpy(x).bfloat16()
    tr = None if r is None else torch.from_numpy(r).bfloat16()
    got = fused_conv3x3_int8(tx, torch.from_numpy(w), torch.from_numpy(b), tr)
    assert got.dtype == torch.bfloat16
    jx = jnp.asarray(x, jnp.bfloat16)
    jw_q, js_w = jax_conv2d._quantize_weight(jnp.asarray(w))
    want = jax_conv2d._xla_reference_int8(
        jx, jw_q, js_w, jax_conv2d._act_scale(jx), jnp.asarray(b),
        None if r is None else jnp.asarray(r, jnp.bfloat16), True)
    _assert_output_close(got, np.asarray(want.astype(jnp.float32)), bf16=True)


def test_packed_weight_is_what_the_kernel_reads():
    _, w, b, _ = _data((1, 4, 4, 64, 16), False, seed=6)
    packed = pack_int8_weight(torch.from_numpy(w), torch.from_numpy(b))
    w_q, s_w = quantize_weight(torch.from_numpy(w))
    assert torch.equal(packed.w_q, w_q) and torch.equal(packed.s_w, s_w)
    assert packed.wt.shape == (16, 9 * 64) and packed.wt.is_contiguous()
    # K contiguous per output channel, taps in (dy, dx, c) order
    assert torch.equal(packed.wt[5].reshape(3, 3, 64), w_q[..., 5])
    x = torch.rand(1, 4, 4, 64)
    a = fused_conv3x3_int8(x, None, None, packed=packed)
    want = conv3x3_int8_reference(x, w_q, s_w, act_scale(x),
                                  torch.from_numpy(b))
    assert torch.equal(a, want)


def test_int8_drift_against_the_f32_conv_is_bounded():
    x, w, b, _ = _data((2, 16, 16, 256, 256), False, seed=3)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    y_q, y_f = fused_conv3x3_int8(*args), fused_conv3x3(*args)
    rel = (y_q - y_f).abs().max() / (y_f.abs().max() + 1e-9)
    assert 0 < rel < 0.03, rel


def test_k7_states_what_it_accepts():
    bf16 = torch.bfloat16
    assert int8_kernel_accepts((20, 32, 32, 256), 256, bf16) is None
    assert int8_kernel_accepts((20, 16, 16, 512), 512, bf16) is None
    assert int8_kernel_accepts((20, 128, 128, 64), 64, torch.float32) is None
    assert "C % 64" in int8_kernel_accepts((1, 8, 8, 96), 64, bf16)
    assert "O % 8" in int8_kernel_accepts((1, 8, 8, 64), 12, bf16)
    assert "W <= 128" in int8_kernel_accepts((1, 8, 256, 64), 64, bf16)
    assert "shared memory" in int8_kernel_accepts((1, 4, 128, 1024), 64, bf16)
    assert "got torch.float16" in int8_kernel_accepts((1, 8, 8, 64), 64,
                                                      torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv3x3_int8(torch.rand(1, 4, 4, 64), torch.rand(3, 3, 64, 8),
                           torch.zeros(8), impl="kernel")


@pytest.fixture
def conv_calls(monkeypatch):
    """Counts the block's calls of the K3 and K7 wrappers."""
    calls = {"K3": 0, "K7": 0}

    def spy(name, attr):
        real = getattr(port_layers, attr)

        def wrapped(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(port_layers, attr, wrapped)

    spy("K3", "fused_conv3x3")
    spy("K7", "fused_conv3x3_int8")
    return calls


def _block(planes, seed):
    torch.manual_seed(seed)
    block = BasicBlock(planes, planes).eval()
    for bn in (block.bn1, block.bn2):
        bn.running_mean.normal_(0, 0.1)
        bn.running_var.uniform_(0.5, 1.5)
    return block


def test_int8_env_gate(monkeypatch, conv_calls):
    """COBEVT_INT8=1 sends the C 256 block through K7 (small, nonzero drift)
    and leaves the C 128 block on K3, bit for bit."""
    rng = np.random.RandomState(4)
    x256 = torch.from_numpy(np.abs(rng.randn(2, 8, 8, 256)).astype("f4"))
    x128 = torch.from_numpy(np.abs(rng.randn(2, 8, 8, 128)).astype("f4"))
    b256, b128 = _block(256, 0), _block(128, 1)
    ops.reset_launch_counts()
    with torch.no_grad(), ops.forced_impl("torch"):
        base256, base128 = b256(x256), b128(x128)
        assert conv_calls == {"K3": 4, "K7": 0}
        monkeypatch.setenv("COBEVT_INT8", "1")
        q256, q128 = b256(x256), b128(x128)
        assert conv_calls == {"K3": 6, "K7": 2}
        b256.train()
        b256(x256)                        # training never takes a fused conv
        assert conv_calls == {"K3": 6, "K7": 2}
    assert torch.equal(q128, base128)
    rel = (q256 - base256).abs().max() / (base256.abs().max() + 1e-9)
    assert 0 < rel < 0.03, rel
    assert ops.launch_counts()["fused_conv3x3_int8"] == 0


def test_block_quantizes_its_weights_once_per_version(monkeypatch):
    monkeypatch.setenv("COBEVT_INT8", "1")
    block = _block(256, 2)
    packs = []
    real = port_conv2d.pack_int8_weight

    def counting(w, shift):
        packs.append(1)
        return real(w, shift)

    monkeypatch.setattr(port_layers, "pack_int8_weight", counting)
    x = torch.rand(1, 4, 4, 256)
    with torch.no_grad():
        a = block(x)
        b = block(x)
        assert len(packs) == 2 and torch.equal(a, b)
        block.conv1.weight.mul_(0.5)      # a new weight version
        c = block(x)
    assert len(packs) == 3 and not torch.equal(a, c)
    assert not any(k.startswith("_int8") for k in block.state_dict())
