"""K4, the fused FuseBEVT encoder, against the JAX package.

The port's SwapFusionEncoder with the fused dispatch (its plain version on
the CPU) against the JAX encoder at COBEVT_FUSED_FUSION=force, whose
Pallas program runs in interpret mode on the CPU, at the sizes of
tests/test_fused_swap_fusion.py: masked and unmasked, both pooling
semantics.  Same numpy weights and inputs, f32.  Tolerance 1e-4 abs /
1e-4 rel: two blocks of LayerNorms, softmaxes and FFNs summed in another
order (the JAX package holds its kernel to the stock path at 2e-4).
"""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cobevt_tpu.models.fusion import swap_fusion as js
from cobevt_tpu_torch.models.fusion import swap_fusion as ps
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    port_from,
)

# the package re-exports the wrapper under the module's own name
pk = importlib.import_module("cobevt_tpu_torch.ops.fused_swap_fusion")
TOL = dict(atol=1e-4, rtol=1e-4)


def _setup(masked, mean_over_valid, B=1, L=3, H=16, W=16, D=64, seed=0):
    rng = np.random.RandomState(seed)
    kw = dict(input_dim=D, mlp_dim=2 * D, agent_size=L, window_size=4,
              dim_head=32, dropout=0.0, depth=2, mask=masked,
              mean_over_valid=mean_over_valid)
    x = rng.randn(B, L, H, W, D).astype(np.float32)
    mask = (rng.rand(B, L, H, W) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0                  # the ego agent keeps every key live
    agent_mask = np.array([[1.0, 1.0, 0.0]] * B, np.float32)
    return kw, x, mask, agent_mask


def _spy(monkeypatch):
    calls = []
    real = ps.fused_swap_fusion

    def spy(*args, **kwargs):
        calls.append(kwargs.get("mean_over_valid"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ps, "fused_swap_fusion", spy)
    return calls


@pytest.mark.parametrize("mean_over_valid", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_encoder_matches_jax_fused(monkeypatch, masked, mean_over_valid):
    """JAX at COBEVT_FUSED_FUSION=force (interpret mode); the port at
    "force" and with the switch unset, both of which take K4 at eval."""
    kw, x, mask, agent_mask = _setup(masked, mean_over_valid)
    jm = js.SwapFusionEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(mask), False)
    v = jax_variables(jm, *jargs, agent_mask=jnp.asarray(agent_mask))
    monkeypatch.setenv("COBEVT_FUSED_FUSION", "force")
    want = jax_apply(jm, v, *jargs, agent_mask=jnp.asarray(agent_mask))
    calls = _spy(monkeypatch)
    port = port_from(ps.SwapFusionEncoder(**kw), v)
    for switch in ("force", None):
        if switch is None:
            monkeypatch.delenv("COBEVT_FUSED_FUSION")
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(mask),
                       agent_mask=torch.from_numpy(agent_mask))
        assert got.shape == (1, 16, 16, 64)
        assert_close(got, want, **TOL)
    assert calls == [mean_over_valid] * 2


def test_stock_switch_and_training_skip_the_kernel(monkeypatch):
    kw, x, mask, agent_mask = _setup(True, False, seed=1)
    jm = js.SwapFusionEncoder(**kw)
    jargs = (jnp.asarray(x), jnp.asarray(mask), False)
    v = jax_variables(jm, *jargs, agent_mask=jnp.asarray(agent_mask))
    port = port_from(ps.SwapFusionEncoder(**kw), v)
    calls = _spy(monkeypatch)
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    with torch.no_grad():
        fused = port(*args, agent_mask=torch.from_numpy(agent_mask))
        monkeypatch.setenv("COBEVT_FUSED_FUSION", "0")
        stock = port(*args, agent_mask=torch.from_numpy(agent_mask))
        monkeypatch.delenv("COBEVT_FUSED_FUSION")
        port.train()
        port(*args, agent_mask=torch.from_numpy(agent_mask))
    assert calls == [False]
    torch.testing.assert_close(fused, stock, atol=1e-4, rtol=1e-4)


def test_plain_version_matches_the_stock_modules_with_a_mostly_masked_window():
    """Window (0, 0) keeps only the ego agent's first token live: the
    additive mask must leave that one key, as the stock K1 mask does."""
    kw, x, mask, agent_mask = _setup(True, True, B=2, seed=2)
    mask[:, :, :4, :4] = 0.0
    mask[:, 0, 0, 0] = 1.0
    port = ps.SwapFusionEncoder(**kw).eval()
    torch.manual_seed(0)
    for p in port.parameters():
        p.data.normal_(0.0, 0.2)
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    am = torch.from_numpy(agent_mask)
    with torch.no_grad():
        fused = port(*args, agent_mask=am)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("COBEVT_FUSED_FUSION", "0")
            stock = port(*args, agent_mask=am)
    assert fused.shape == (2, 16, 16, 64)
    torch.testing.assert_close(fused, stock, atol=1e-4, rtol=1e-4)


def test_windows_round_trip_and_grid_cells():
    t = torch.arange(2 * 3 * 8 * 12 * 5, dtype=torch.float32).reshape(
        2, 3, 8, 12, 5)
    for grid in (False, True):
        w = pk.to_windows(t, 4, grid)
        assert w.shape == (2, 6, 48, 5)
        torch.testing.assert_close(pk.from_windows(w, 3, 8, 12, 4, grid), t)
    # grid cell (x, y) = (1, 2): token (l, p, s) at row p*2 + 1, col s*3 + 2
    g = pk.to_windows(t, 4, True)
    torch.testing.assert_close(g[1, 1 * 3 + 2, 2 * 16 + 3 * 4 + 1],
                               t[1, 2, 3 * 2 + 1, 1 * 3 + 2])


@pytest.mark.parametrize("shape,ok", [
    ((5, 32, 32, 128, 8, 4, 256), True),    # CorpBEVT
    ((4, 8, 8, 32, 4, 4, 32), True),        # head dim 8
    ((5, 32, 32, 128, 6, 4, 256), False),   # windows do not tile the map
    ((5, 32, 32, 128, 8, 2, 256), False),   # head dim 64
    ((3, 8, 8, 32, 3, 4, 32), False),       # 27 tokens a window
    ((5, 32, 32, 512, 8, 16, 1024), False),  # row tiles over shared memory
])
def test_kernel_accepts(shape, ok):
    assert pk.kernel_accepts(*shape) is ok


def test_packed_operands_are_reused_until_the_weights_change():
    kw, x, mask, agent_mask = _setup(True, False, seed=3)
    port = ps.SwapFusionEncoder(**kw).eval()
    args = (torch.from_numpy(x), torch.from_numpy(mask))
    with torch.no_grad():
        first_out = port(*args)
        first = port._packed.get("encoder", list(port.parameters()),
                                 lambda: None, 3, torch.float32)
        assert first is not None
        port(*args)
        assert port._packed.get("encoder", list(port.parameters()),
                                lambda: None, 3, torch.float32) is first
        # an in-place update (as load_state_dict makes) repacks
        port.mlp_head[3].bias.add_(1.0)
        second_out = port(*args)
    torch.testing.assert_close(second_out, first_out + 1.0, atol=1e-5,
                               rtol=1e-5)
