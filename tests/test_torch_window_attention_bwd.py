"""K5 and K8 of the port against the JAX package, f32 on the CPU.

The same numpy inputs go through both sides.  K5's plain version
(``packed_backward_reference``) is held against the Pallas backward body
in interpret mode and against ``jax.grad`` of the packed function; the
composite backward and the two switches against ``jax.grad`` with the same
switches; K8 against ``fused_window_attention``.  Tolerance 2e-5 abs / 1e-4
rel: the same f32 arithmetic, summed in another order (exp and reciprocal
differ by an ulp between the two libraries).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from cobevt_tpu.ops import window_attention as jwa
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.ops import window_attention as pwa

TOL = dict(atol=2e-5, rtol=1e-4)
COMBOS = ["", "bias", "mask", "bias+mask"]


def packed_data(extras, G=3, H=4, Tq=16, Tk=24, D=32, seed=0):
    rng = np.random.RandomState(seed)
    C = H * D
    d = {"q": rng.randn(G, Tq, C) * D ** -0.5, "k": rng.randn(G, Tk, C),
         "v": rng.randn(G, Tk, C), "g": rng.randn(G, Tq, C),
         "bias": None, "mask": None, "weight": None}
    if "bias" in extras:
        d["bias"] = rng.randn(Tq, H * Tk)
    if "mask" in extras:
        d["mask"] = (rng.rand(G, Tk) > 0.3).astype(np.float32)
        d["mask"][1] = 0.0                       # a fully masked window
    if "weight" in extras:
        d["weight"] = (rng.rand(G, Tq, H * Tk) > 0.2) / 0.8
    return {k: None if v is None else v.astype(np.float32)
            for k, v in d.items()}, H


def _t(a, grad=False):
    if a is None:
        return None
    t = torch.from_numpy(a.copy())
    return t.requires_grad_() if grad else t


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=name, **TOL)


@pytest.mark.parametrize("extras", COMBOS)
def test_k5_plain_version_matches_pallas_body(extras):
    d, H = packed_data(extras)
    out_j = jwa._packed_forward_core(
        _j(d["q"]), _j(d["k"]), _j(d["v"]), _j(d["bias"]), _j(d["mask"]),
        None, H, use_pallas=False, interpret=False)
    want = jwa._packed_bwd_pallas(
        _j(d["q"]), _j(d["k"]), _j(d["v"]), _j(d["bias"]), _j(d["mask"]),
        _j(d["g"]), out_j, H, interpret=True)
    out = torch.from_numpy(np.array(out_j))
    before = dict(ops.launch_counts())
    got = pwa.fused_window_attention_packed_bwd(
        _t(d["q"]), _t(d["k"]), _t(d["v"]), _t(d["g"]), out, H,
        _t(d["bias"]), _t(d["mask"]))
    assert ops.launch_counts() == before         # the CPU launches nothing
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, name)


def _jax_grads(d, H, extras, env=None):
    names = ["q", "k", "v"] + (["bias"] if d["bias"] is not None else []) + (
        ["weight"] if d["weight"] is not None else [])

    def loss(*args):
        a = dict(zip(names, args))
        out = jwa.fused_window_attention_packed(
            a["q"], a["k"], a["v"], H, bias_flat=a.get("bias"),
            mask=_j(d["mask"]), weight=a.get("weight"))
        return (out * _j(d["g"])).sum()

    grads = jax.grad(loss, argnums=tuple(range(len(names))))(
        *[_j(d[n]) for n in names])
    return dict(zip(names, grads))


def _port_grads(d, H):
    leaves = {n: _t(d[n], grad=True) for n in ("q", "k", "v", "bias",
                                               "weight")}
    out = pwa.fused_window_attention_packed(
        leaves["q"], leaves["k"], leaves["v"], H, bias_flat=leaves["bias"],
        mask=_t(d["mask"]), weight=leaves["weight"])
    out.backward(_t(d["g"]))
    return {n: t.grad for n, t in leaves.items() if t is not None}


@pytest.mark.parametrize("extras", COMBOS + ["weight", "bias+weight"])
@pytest.mark.parametrize("switch", ["default", "COBEVT_FLASH_BWD=0",
                                    "COBEVT_FLASH_BWD_F32=1"])
def test_packed_gradients_match_jax_grad(monkeypatch, extras, switch):
    """autograd through the port's wrapper against ``jax.grad`` of the
    packed function under the same switch.  By default the weight-free
    cases take K5's plain version and the weighted ones the composite."""
    if switch != "default":
        name, value = switch.split("=")
        monkeypatch.setenv(name, value)
    d, H = packed_data(extras)
    kernel_path = switch == "default" and "weight" not in extras
    assert pwa.packed_bwd_kernel_ok(_t(d["q"]), _t(d["k"]), _t(d["weight"]),
                                    H) == ("weight" not in extras)
    calls = []
    monkeypatch.setattr(
        pwa, "packed_backward_reference",
        lambda *a, _f=pwa.packed_backward_reference: (calls.append(1),
                                                      _f(*a))[1])
    got = _port_grads(d, H)
    assert bool(calls) == kernel_path
    want = _jax_grads(d, H, extras)
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)


def test_mask_and_weight_without_grad_get_none():
    d, H = packed_data("bias+mask")
    mask = _t(d["mask"], grad=True)
    q, k, v = (_t(d[n], grad=True) for n in ("q", "k", "v"))
    pwa.fused_window_attention_packed(q, k, v, H, _t(d["bias"]),
                                      mask).sum().backward()
    assert mask.grad is None and q.grad is not None
    with pytest.raises(ValueError, match="weight\\+mask"):
        pwa.fused_window_attention_packed(q, k, v, H, mask=mask,
                                          weight=torch.ones(3, 16, 96))


def test_k5_gate_keeps_semantics_and_kernel_limits():
    q = torch.zeros(2, 16, 128)
    assert pwa.packed_bwd_kernel_ok(q, q, None, 4)           # D 32
    assert pwa.packed_bwd_kernel_ok(q, q, None, 8)           # D 16
    assert not pwa.packed_bwd_kernel_ok(q, q, None, 16)      # D 8
    assert not pwa.packed_bwd_kernel_ok(q, q, torch.ones(2, 16, 64), 4)
    # any Tq: K5 takes ragged query windows (the nuScenes 100 and 625)
    assert pwa.packed_bwd_kernel_ok(q[:, :12], q, None, 4)
    assert not pwa.packed_bwd_kernel_ok(q, q[:, :4], None, 4)    # Tk % 8
    assert not pwa.packed_bwd_kernel_ok(q.half(), q.half(), None, 4)
    # C % 128 and the VMEM residency of the JAX gate are TPU tuning
    assert pwa.packed_bwd_kernel_ok(q[..., :64], q[..., :64], None, 2)


def head_major_data(extras, G=3, H=2, Tq=16, Tk=24, D=16, seed=1):
    rng = np.random.RandomState(seed)
    d = {"q": rng.randn(G, H, Tq, D) * D ** -0.5, "k": rng.randn(G, H, Tk, D),
         "v": rng.randn(G, H, Tk, D), "g": rng.randn(G, H, Tq, D),
         "bias": rng.randn(H, Tq, Tk) if "bias" in extras else None,
         "mask": None}
    if "mask" in extras:
        d["mask"] = (rng.rand(G, Tk) > 0.3).astype(np.float32)
        d["mask"][2] = 0.0
    return {k: None if v is None else v.astype(np.float32)
            for k, v in d.items()}


@pytest.mark.parametrize("extras", COMBOS)
@pytest.mark.parametrize("switch", ["default", "COBEVT_FLASH_BWD=0",
                                    "COBEVT_FLASH_BWD_F32=1"])
def test_k8_forward_and_gradients_match_jax(monkeypatch, extras, switch):
    if switch != "default":
        name, value = switch.split("=")
        monkeypatch.setenv(name, value)
    d = head_major_data(extras)
    names = ["q", "k", "v"] + (["bias"] if d["bias"] is not None else [])

    def fwd(*args):
        a = dict(zip(names, args))
        return jwa.fused_window_attention(a["q"], a["k"], a["v"],
                                          a.get("bias"), _j(d["mask"]),
                                          interpret=True)

    args = [_j(d[n]) for n in names]
    want_out = fwd(*args)
    want = jax.grad(lambda *a: (fwd(*a) * _j(d["g"])).sum(),
                    argnums=tuple(range(len(names))))(*args)
    leaves = {n: _t(d[n], grad=True) for n in names}
    out = pwa.fused_window_attention(leaves["q"], leaves["k"], leaves["v"],
                                     leaves.get("bias"), _t(d["mask"]))
    out.backward(_t(d["g"]))
    _close(out, want_out, "out")
    for name, w in zip(names, want):
        _close(leaves[name].grad, w, name)
    assert ops.fused_window_attention is pwa.fused_window_attention


def test_k8_kernel_impl_on_cpu_raises():
    d = head_major_data("")
    q, k, v = (_t(d[n]) for n in ("q", "k", "v"))
    with pytest.raises(ValueError, match="CUDA"):
        pwa.fused_window_attention(q, k, v, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        pwa.fused_window_attention_packed_bwd(q, k, v, q, q, 2,
                                              impl="kernel")
