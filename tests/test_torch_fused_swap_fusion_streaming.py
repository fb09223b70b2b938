"""K6, the streaming FuseBEVT sublayer, against the JAX package.

The port's SwapFusionEncoder on the K6 branch (its plain version on the
CPU) against the JAX encoder at COBEVT_FUSED_FUSION=force-stream, whose
Pallas body runs in interpret mode on the CPU, at the sizes of
tests/test_fused_swap_fusion.py: L 3, 16 x 16, window 8, D 128 (one head
group) and D 256 (two), masked and not, both pooling semantics, B 1 and 2;
and SECOND's D 512 (mlp 256) at L 2, 8 x 16.
Same numpy weights and inputs.  f32: 3e-4 abs / 3e-4 rel, the tolerance the
JAX package holds its kernel to against its stock path.  bf16: 6e-2 abs /
2e-2 rel: the port takes the row maximum per head where the TPU body takes
it over a 128-channel head group, so the exp rounds to bf16 at another place
(one bf16 ulp on a weight), and the residual state is rounded to bf16 after
each of four sublayers, where a one-ulp flip at |x| ~ 4 (0.03) carries on.
Then the dispatch between K4, K6 and the stock modules.
"""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.models.fusion import swap_fusion as js
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.models.fusion import swap_fusion as ps
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

pk = importlib.import_module("cobevt_tpu_torch.ops.fused_swap_fusion")
TOL = dict(atol=3e-4, rtol=3e-4)
BF16_TOL = dict(atol=6e-2, rtol=2e-2)


def _setup(masked, mean_over_valid=False, B=1, L=3, H=16, W=16, D=128,
           depth=2, window=8, seed=1, mlp=None):
    rng = np.random.RandomState(seed)
    kw = dict(input_dim=D, mlp_dim=mlp or 2 * D, agent_size=L,
              window_size=window,
              dim_head=32, dropout=0.0, depth=depth, mask=masked,
              mean_over_valid=mean_over_valid)
    x = rng.randn(B, L, H, W, D).astype(np.float32)
    mask = (rng.rand(B, L, H, W) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0                  # the ego agent keeps every key live
    agent_mask = np.array([[1.0] * (L - 1) + [0.0]] * B, np.float32)
    return kw, x, mask, agent_mask


def _spies(monkeypatch):
    """Record which fused entry point the encoder calls."""
    calls = []
    for name in ("fused_swap_fusion", "fused_swap_fusion_streaming"):
        real = getattr(ps, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(ps, name, spy)
    return calls


def _jax_streaming(monkeypatch, jm, v, *jargs, **kwargs):
    """The JAX encoder at force-stream, with proof that it took the
    streaming kernel."""
    calls = []
    real = js.fused_swap_fusion_streaming

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(js, "fused_swap_fusion_streaming", spy)
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "force-stream")
    out = jax_apply(jm, v, *jargs, **kwargs)
    assert calls
    return out


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dim", [128, 256])
def test_encoder_matches_jax_streaming(monkeypatch, masked, dim):
    kw, x, mask, _ = _setup(masked, D=dim)
    jm = js.SwapFusionEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(mask), False)
    v = jax_variables(jm, *jargs)
    want = _jax_streaming(monkeypatch, jm, v, *jargs)
    calls = _spies(monkeypatch)
    port = port_from(ps.SwapFusionEncoder(**kw), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (1, 16, 16, dim)
    assert calls == ["fused_swap_fusion_streaming"]
    assert_close(got, want, **TOL)


def test_encoder_matches_jax_streaming_at_d512(monkeypatch):
    """SECOND's widths (D 512, 16 heads of 32, mlp 256, depth 1) at a small
    map: 2 agents, 8 x 16, two windows of 8 (the JAX gate ``streams``
    takes SECOND's window of 4 only where it spans the whole map)."""
    kw, x, mask, _ = _setup(True, L=2, H=8, W=16, D=512, depth=1, seed=4,
                            mlp=256)
    jm = js.SwapFusionEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(mask), False)
    v = jax_variables(jm, *jargs)
    want = _jax_streaming(monkeypatch, jm, v, *jargs)
    calls = _spies(monkeypatch)
    port = port_from(ps.SwapFusionEncoder(**kw), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (1, 8, 16, 512)
    assert calls == ["fused_swap_fusion_streaming"]
    assert_close(got, want, **TOL)


@pytest.mark.parametrize("B", [1, 2])
def test_streaming_mean_over_valid_matches_jax(monkeypatch, B):
    kw, x, mask, agent_mask = _setup(True, True, B=B, depth=1, seed=2)
    jm = js.SwapFusionEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(mask), False)
    v = jax_variables(jm, *jargs, agent_mask=jnp.asarray(agent_mask))
    want = _jax_streaming(monkeypatch, jm, v, *jargs,
                          agent_mask=jnp.asarray(agent_mask))
    port = port_from(ps.SwapFusionEncoder(**kw), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask),
                   agent_mask=torch.from_numpy(agent_mask))
        all_agents = port(torch.from_numpy(x), torch.from_numpy(mask))
    assert_close(got, want, **TOL)
    assert not torch.allclose(got, all_agents, atol=1e-3)


def test_streaming_bf16_matches_the_interpret_mode_body(monkeypatch):
    kw, x, mask, _ = _setup(True, D=256, seed=3)
    jm = js.SwapFusionEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(mask), False)
    v = jax_variables(jm, *jargs)
    want = _jax_streaming(monkeypatch, jm, v,
                          jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
                          False)
    assert want.dtype == jnp.bfloat16
    port = port_from(ps.SwapFusionEncoder(**kw), v).to(torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
        f32 = port.float()(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert_close(got, want, **BF16_TOL)
    # and the bf16 chain is the f32 one up to its roundings
    assert float((got.float() - f32).abs().max()) < 0.25


def test_plain_version_matches_the_stock_modules_with_a_fully_masked_window():
    """Window (0, 0) has no live key: -1e9 on every key leaves the softmax
    uniform and finite, in K6's plain version as in K1's."""
    kw, x, mask, _ = _setup(True, B=2, D=128, depth=1, seed=4)
    mask[:, :, :8, :8] = 0.0
    port = ps.SwapFusionEncoder(**kw).eval()
    torch.manual_seed(0)
    for p in port.parameters():
        p.data.normal_(0.0, 0.1)
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setenv("COBEVT_FUSED_FUSION", "force-stream")
        fused = port(*args)
        mp.setenv("COBEVT_FUSED_FUSION", "0")
        stock = port(*args)
    assert torch.isfinite(fused).all()
    torch.testing.assert_close(fused, stock, atol=1e-4, rtol=1e-4)


# (B, L, H, W, D), encoder keywords, switch, training -> entry point.
# Beyond K4's resident budget the JAX package streams (K6); the port's
# default and "force" take the stock modules there (on the H100 they beat
# K6), and only "force-stream" takes K6: the "*_k6" names below are the
# JAX package's branch, the entry point the port's.
DISPATCH = {
    "corpbevt_fits_k4": ((1, 5, 32, 32, 128), {}, None, False,
                         "fused_swap_fusion"),
    "state_over_budget_k6": ((1, 5, 64, 64, 128), {}, None, False,
                             "fused_swap_fusion_streaming"),
    "force_state_over_budget_k6": ((1, 5, 64, 64, 128), {}, "force", False,
                                   "fused_swap_fusion_streaming"),
    # the H100 term that sent this state to the stock modules went with
    # K6's wgmma kernels: "1" streams, as in the JAX package
    "state_over_budget_switch_1_stock": ((1, 5, 64, 64, 128), {}, "1",
                                         False,
                                         "fused_swap_fusion_streaming"),
    "force_stream_state_over_budget_k6": (
        (1, 5, 64, 64, 128), {}, "force-stream", False,
        "fused_swap_fusion_streaming"),
    "wide_tokens_k4_tiles_too_large_k6": (
        (1, 3, 16, 16, 256), dict(input_dim=256, mlp_dim=512), "1", False,
        "fused_swap_fusion_streaming"),
    "force_wide_tokens_k4_tiles_too_large_k6": (
        (1, 3, 16, 16, 256), dict(input_dim=256, mlp_dim=512), "force",
        False, "fused_swap_fusion_streaming"),
    "force_stream_where_k4_fits": ((1, 5, 32, 32, 128), {}, "force-stream",
                                   False, "fused_swap_fusion_streaming"),
    "force_stream_head_dim_8_k6": (
        (1, 2, 8, 8, 64), dict(input_dim=64, mlp_dim=64, dim_head=8,
                               window_size=4), "force-stream", False,
        "fused_swap_fusion_streaming"),
    "width_48_neither_gate_k4": (
        (1, 2, 8, 8, 48), dict(input_dim=48, mlp_dim=48, dim_head=16,
                               window_size=4), "force-stream", False,
        "fused_swap_fusion"),
    "width_96_k6_does_not_take_k4": (
        (1, 2, 8, 8, 96), dict(input_dim=96, mlp_dim=96, dim_head=32,
                               window_size=4), "force-stream", False,
        "fused_swap_fusion"),
    "switch_0_stock": ((1, 5, 64, 64, 128), {}, "0", False, None),
    "training_stock": ((1, 5, 64, 64, 128), {}, None, True, None),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_dispatch(monkeypatch, name):
    """The old fault: at (1, 5, 64, 64, 128) the port ran K4 (bf16 bias)
    where the JAX package runs K6 (f32 bias), because its gate had no size
    term.  That state streams (K6) under "1", "force" and "force-stream",
    the JAX package's rule; "0" and training take the stock modules."""
    shape, extra, switch, training, entry = DISPATCH[name]
    kw = dict(input_dim=128, mlp_dim=256, agent_size=shape[1], window_size=8,
              dim_head=32, dropout=0.0, depth=1, mask=True)
    kw.update(extra)
    if switch is None:
        monkeypatch.delenv("COBEVT_FUSED_FUSION", raising=False)
    else:
        monkeypatch.setenv("COBEVT_FUSED_FUSION", switch)
    port = ps.SwapFusionEncoder(**kw).train(training)
    kernel = {None: None, "fused_swap_fusion": "K4",
              "fused_swap_fusion_streaming": "K6"}[entry]
    assert port.fused_kernel(shape) == kernel
    calls = _spies(monkeypatch)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    mask = torch.ones(shape[:4])
    with torch.no_grad():
        out = port(x, mask)
    assert out.shape == (shape[0], shape[2], shape[3], shape[4])
    assert calls == ([] if entry is None else [entry])


def test_k6_in_k4s_place_rounds_the_bias_as_k4_does(monkeypatch):
    """At (1, 3, 16, 16, 256), mlp 512, 8 heads the state fits K4's resident
    budget, so the JAX package runs K4 there, with the bias tables cast to
    the compute dtype; the port's K4 does not take D 256 with mlp 512, so K6
    runs in its place and must see the same bf16-rounded bias, carried in
    f32.  f32 parameters, bf16 activations (the mixed case in which the
    rounding shows).  JAX at "force" takes K4 in interpret mode on the CPU
    (its "1" takes the stock modules off a TPU)."""
    kw, x, mask, _ = _setup(True, D=256, depth=1, seed=8)
    jm = js.SwapFusionEncoder(**kw)
    v = jax_variables(jm, jnp.asarray(x), jnp.asarray(mask), False)
    k4 = []
    real = js.fused_swap_fusion

    def jax_spy(*a, **k):
        k4.append(1)
        return real(*a, **k)

    monkeypatch.setattr(js, "fused_swap_fusion", jax_spy)
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "force")
    want = jax_apply(jm, v, jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
                     False)
    assert k4 and want.dtype == jnp.bfloat16
    monkeypatch.delenv("COBEVT_FUSED_FUSION")

    port = port_from(ps.SwapFusionEncoder(**kw), v)
    assert port.fused_kernel(x.shape) == "K6"
    seen = []
    real_k6 = ps.fused_swap_fusion_streaming

    def spy(*a, **k):
        seen.append(a[4])
        return real_k6(*a, **k)

    monkeypatch.setattr(ps, "fused_swap_fusion_streaming", spy)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    raw = port._pack(3, torch.float32, torch.float32).bias
    assert len(seen) == 1 and seen[0].bias.dtype == torch.float32
    assert torch.equal(seen[0].bias, raw.to(torch.bfloat16).float())
    assert not torch.equal(seen[0].bias, raw)
    assert got.dtype == torch.bfloat16
    assert_close(got, want, **BF16_TOL)


def test_lidar_shape_streams_without_looking_at_the_device(monkeypatch):
    """The LiDAR map streams (K6) by default and under "force-stream", and
    takes the stock modules under "0"."""
    enc = ps.SwapFusionEncoder(input_dim=256, mlp_dim=512, agent_size=5,
                               window_size=8, dim_head=32, depth=2).eval()
    monkeypatch.delenv("COBEVT_FUSED_FUSION", raising=False)
    assert enc.fused_kernel((1, 5, 96, 176, 256)) == "K6"
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "0")
    assert enc.fused_kernel((1, 5, 96, 176, 256)) is None
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "force-stream")
    assert enc.fused_kernel((1, 5, 96, 176, 256)) == "K6"
    assert not pk.kernel_accepts(5, 96, 176, 256, 8, 8, 512)
    assert not pk.fits_resident(5, 96, 176, 256, 8, 8)
    # windows that do not tile the map take no fused kernel
    assert enc.fused_kernel((1, 5, 100, 176, 256)) is None


@pytest.mark.parametrize("shape,ok", [
    ((5, 96, 176, 256, 8, 8, 512), True),    # the cooperative LiDAR map
    ((3, 16, 16, 128, 8, 4, 256), True),
    ((3, 16, 16, 256, 8, 8, 512), True),
    ((2, 8, 8, 64, 4, 8, 64), True),         # head dim 8
    ((5, 96, 176, 256, 7, 8, 512), False),   # windows do not tile the map
    ((5, 96, 176, 256, 8, 4, 512), False),   # head dim 64
    ((3, 9, 9, 128, 3, 4, 256), False),      # 27 tokens a window
    ((5, 32, 32, 48, 8, 3, 96), False),      # D not a multiple of 64
    ((5, 32, 32, 96, 8, 3, 192), False),     # D 32 * odd
    ((5, 32, 32, 128, 8, 4, 288), False),    # mlp 32 * odd
    ((5, 32, 32, 512, 8, 16, 1024), True),   # row tiles: 132 KB
    ((5, 32, 32, 1024, 8, 32, 2048), False),  # row tiles: 263 KB
    ((5, 32, 32, 896, 8, 28, 1792), True),   # row tiles: 225.5 of 226 KB
    ((5, 32, 32, 960, 8, 30, 1920), False),  # row tiles: 241 KB
])
def test_stream_accepts(shape, ok):
    assert pk.stream_accepts(*shape) is ok


def test_stream_row_tiles_fit_beside_two_more_blocks_at_the_lidar_width():
    """16 rows of f32 at D 256, mlp 512: 67 KB, three blocks to an SM."""
    tiles = max(pk._pad(256) + pk._pad(768), 2 * pk._pad(256) + pk._pad(512))
    assert 3 * pk.STREAM_ROWS * tiles * 4 <= pk.SMEM_BYTES


@pytest.mark.parametrize("shape,ok", [
    ((5, 32, 32, 128, 8, 4), True),          # CorpBEVT: 1.6 MB, 1.3 MB
    ((5, 64, 64, 128, 8, 4), False),         # 5.2 MB of state
    ((5, 96, 176, 256, 8, 8), False),        # the LiDAR map
    ((5, 16, 16, 128, 8, 8), False),         # 3.3 MB of bias
    ((5, 30, 32, 128, 8, 4), False),         # windows do not tile the map
])
def test_fits_resident(shape, ok):
    assert pk.fits_resident(*shape) is ok


def test_k6_pack_keeps_the_bias_in_f32_and_its_own_cache_entry(monkeypatch):
    kw, x, mask, _ = _setup(True, D=128, depth=1, seed=6)
    port = ps.SwapFusionEncoder(**kw).eval().to(torch.bfloat16)
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    with torch.no_grad():
        k4 = port(*args)
        monkeypatch.setenv("COBEVT_FUSED_FUSION", "force-stream")
        k6 = port(*args)
    params = list(port.parameters())
    packed4 = port._packed.get("encoder", params, lambda: None, 3,
                               torch.bfloat16)
    packed6 = port._packed.get("stream", params, lambda: None, 3,
                               torch.bfloat16)
    assert packed4.bias.dtype == torch.bfloat16
    assert packed6.bias.dtype == torch.float32
    assert packed6.layers[0][0]["wqkv_t"].dtype == torch.bfloat16
    assert packed6.bias.shape == (1, 2, 192, 4 * 192)
    assert k4.dtype == k6.dtype == torch.bfloat16
    # a pack made for one kernel is refused by the other
    with pytest.raises(ValueError, match="bias"):
        pk.fused_swap_fusion_streaming(args[0], args[1], None, None, packed4,
                                       None, 8, 4)


def test_wrapper_runs_the_plain_version_on_cpu_and_refuses_the_kernel():
    kw, x, mask, agent_mask = _setup(True, D=128, depth=1, seed=7)
    port = ps.SwapFusionEncoder(**kw).eval()
    packed = port._pack(3, torch.float32, torch.float32)
    args = (torch.from_numpy(x), torch.from_numpy(mask),
            torch.from_numpy(agent_mask), None, packed, None, 8, 4)
    ops.reset_launch_counts()
    with torch.no_grad():
        got = pk.fused_swap_fusion_streaming(*args, mean_over_valid=True)
        want = pk.swap_fusion_streaming_reference(*args,
                                                  mean_over_valid=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert ops.launch_counts()["fused_swap_fusion_streaming"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        pk.fused_swap_fusion_streaming(*args, impl="kernel")
