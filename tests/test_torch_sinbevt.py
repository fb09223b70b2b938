"""The ported SinBEVT-OPV2V graph (CorpBEVT without fusion) against the JAX
package.

Small config of tests/test_corpbevt_parity.py (ResNet-18, 2 cameras of
128^2, BEV 64^2, FAX dims 32), two agents decoded independently, with
shifted camera poses.  Both switch settings, as tests/test_torch_corpbevt.py
runs them: "stock" (COBEVT_FUSED_XATTN=0: the FAX branches and the final
self-attention through K1's plain version) and "fused" (the serving
default: K2's plain version for every cross-view branch, K1 for the
self-attention).  Same numpy weights and inputs, f32 on the CPU; 1e-4 abs
/ 1e-3 rel on the seg logits.
"""

import numpy as np
import pytest
import jax
import torch

from cobevt_tpu.models.corpbevt import SinBEVT as JaxSinBEVT
from cobevt_tpu.utils.torch_port import (
    fit_to_template,
    state_dict_to_numpy,
    torch_to_flax,
)
from cobevt_tpu_torch.models import fax as port_fax
from cobevt_tpu_torch.models.corpbevt import SinBEVT
from tests.test_corpbevt_parity import our_config
from tests.test_torch_corpbevt import port_config
from tests.torch_parity import (
    assert_close,
    jax_apply,
    jax_variables,
    jnp_tree,
    port_from,
)

TOL = dict(atol=1e-4, rtol=1e-3)
L, M, IMG = 2, 2, 128


@pytest.fixture(params=["stock", "fused"])
def switches(request, monkeypatch):
    if request.param == "stock":
        monkeypatch.setenv("COBEVT_FUSED_XATTN", "0")
    else:
        monkeypatch.delenv("COBEVT_FUSED_XATTN", raising=False)
    return request.param


def make_batch(seed=0):
    rng = np.random.RandomState(seed)
    intr = np.zeros((1, L, M, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = 120.0
    intr[..., 0, 2] = intr[..., 1, 2] = IMG / 2
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (1, L, M, 1, 1))
    extr[..., :3, 3] = rng.randn(1, L, M, 3) * 0.5
    return {"inputs": rng.rand(1, L, M, IMG, IMG, 3).astype(np.float32),
            "intrinsic": intr, "extrinsic": extr}


@pytest.fixture(scope="module")
def models():
    jm = JaxSinBEVT(our_config())
    v = jax_variables(jm, jnp_tree(make_batch()), False, seed=2)
    return jm, v, port_from(SinBEVT(port_config(our_config())), v)


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_matches_jax(models, seed, switches, monkeypatch):
    jm, v, port = models
    calls = {"K1": 0, "K2": 0}
    for name, attr in (("K1", "fused_window_attention_packed"),
                       ("K2", "fused_cross_view_attention")):
        real = getattr(port_fax, attr)

        def wrapped(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(port_fax, attr, wrapped)
    batch = make_batch(seed)
    want = jax_apply(jm, v, jnp_tree(batch), False)
    with torch.no_grad():
        got = port({k: torch.from_numpy(a) for k, a in batch.items()})
    assert got["dynamic_seg"].shape == (1, L, 64, 64, 2)
    assert_close(got, want, **TOL)
    # six cross-view branches and the final self-attention
    assert calls == ({"K1": 1, "K2": 6} if switches == "fused"
                     else {"K1": 7, "K2": 0})
    # vacuity guard: the agents' maps differ, as their images do
    assert float((got["dynamic_seg"][:, 0] - got["dynamic_seg"][:, 1])
                 .abs().max()) > 1e-3


def test_bridge_round_trip_gives_the_jax_tree(models):
    _, v, port = models
    converted = torch_to_flax(state_dict_to_numpy(port.state_dict()))
    assert set(converted) == set(v)
    for col in v:
        back = fit_to_template(converted[col], v[col])
        jax.tree.map(np.testing.assert_array_equal, back, v[col])
