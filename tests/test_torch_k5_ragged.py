"""K5 at ragged query windows: its plain version against the JAX package.

The nuScenes train step sends K5 (the flash backward of packed window
attention) windows of 600, 100 and 625 queries; since the nuScenes training
slice K5 takes any Tq >= 1, where the JAX package, whose Pallas gate needs
Tq % 8 == 0 (a TPU sublane rule), takes its XLA composite.  The same numpy
inputs go through K5's plain version (``packed_backward_reference``, what a
CPU tensor runs), the Pallas backward body in interpret mode and ``jax.grad``
of the packed function, at Tq 100, 625 and 1.  Tolerance 2e-5 abs / 1e-4 rel
as in tests/test_torch_window_attention_bwd.py: the same f32 arithmetic,
summed in another order.  Also, without a device: the gates and shape checks
at the full-width nuScenes shapes (K5 takes them, K8 keeps its multiples of
8) and the row pitch of the statistics scratch.
"""

import numpy as np
import pytest
import jax
import torch

from cobevt_tpu.ops import window_attention as jwa
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.ops import window_attention as pwa
from tests.test_torch_window_attention_bwd import (
    _close,
    _j,
    _jax_grads,
    _t,
    packed_data,
)

# (Tq, Tk, heads, windows): the nuScenes grid and stage-1 windows, stage 2's
# window of 625 queries (over 432 keys here: the 2,520 of the card's shape
# only lengthen the sums), and a window of one query
RAGGED = [(100, 432, 2, 3), (625, 432, 4, 2), (1, 24, 2, 3)]


def _ragged(extras, Tq, Tk, H, G):
    return packed_data(extras, G=G, H=H, Tq=Tq, Tk=Tk, D=32, seed=Tq)


@pytest.mark.parametrize("extras", ["", "bias+mask"])
@pytest.mark.parametrize("Tq,Tk,H,G", RAGGED)
def test_k5_plain_version_matches_pallas_body_at_ragged_tq(extras, Tq, Tk, H,
                                                            G):
    d, H = _ragged(extras, Tq, Tk, H, G)
    out_j = jwa._packed_forward_core(
        _j(d["q"]), _j(d["k"]), _j(d["v"]), _j(d["bias"]), _j(d["mask"]),
        None, H, use_pallas=False, interpret=False)
    want = jwa._packed_bwd_pallas(
        _j(d["q"]), _j(d["k"]), _j(d["v"]), _j(d["bias"]), _j(d["mask"]),
        _j(d["g"]), out_j, H, interpret=True)
    before = dict(ops.launch_counts())
    got = pwa.fused_window_attention_packed_bwd(
        _t(d["q"]), _t(d["k"]), _t(d["v"]), _t(d["g"]),
        torch.from_numpy(np.array(out_j)), H, _t(d["bias"]), _t(d["mask"]))
    assert ops.launch_counts() == before         # the CPU launches nothing
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert (a is None) == (b is None)
        if a is not None:
            _close(a, b, name)


@pytest.mark.parametrize("Tq,Tk,H,G", RAGGED)
def test_k5_path_matches_jax_grad_at_ragged_tq(monkeypatch, Tq, Tk, H, G):
    """autograd through the port's wrapper takes K5's plain version at a
    ragged Tq (the JAX package there takes its XLA composite) and agrees
    with ``jax.grad``."""
    d, H = _ragged("", Tq, Tk, H, G)
    assert pwa.packed_bwd_kernel_ok(_t(d["q"]), _t(d["k"]), None, H)
    calls = []
    monkeypatch.setattr(
        pwa, "packed_backward_reference",
        lambda *a, _f=pwa.packed_backward_reference: (calls.append(1),
                                                      _f(*a))[1])
    leaves = {n: _t(d[n], grad=True) for n in ("q", "k", "v")}
    out = pwa.fused_window_attention_packed(leaves["q"], leaves["k"],
                                            leaves["v"], H)
    out.backward(_t(d["g"]))
    assert calls == [1]
    want = _jax_grads(d, H, "")
    for name in ("q", "k", "v"):
        _close(leaves[name].grad, want[name], name)


# the six K5 calls of a nuScenes train step at B 8 (G, Tq, Tk, heads): stage
# 0's local and grid branches, stage 1 (both branches), stage 2 (both)
NUSC_SHAPES = [(800, 600, 432, 1), (800, 100, 432, 1), (200, 100, 432, 2),
               (8, 625, 2520, 4)]


@pytest.mark.parametrize("G,Tq,Tk,H", NUSC_SHAPES)
def test_k5_takes_the_nuscenes_shapes_and_k8_refuses_them(G, Tq, Tk, H):
    """Device-free: K5's gate and shape check hold at the nuScenes step's
    windows in both dtypes; K8's check still refuses a ragged Tq; the JAX
    gate, a TPU tiling rule, refuses the ragged ones."""
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.empty((1, Tq, H * 32), dtype=dtype, device="meta")
        k = torch.empty((1, Tk, H * 32), dtype=dtype, device="meta")
        assert pwa.packed_bwd_kernel_ok(q, k, None, H)
        pwa.check_k5_shapes(dtype, Tq, Tk, 32)
    if Tq % 8:
        with pytest.raises(ValueError, match="multiples of 8"):
            pwa.check_k8_shapes(torch.bfloat16, Tq, Tk, 32)
    else:
        pwa.check_k8_shapes(torch.bfloat16, Tq, Tk, 32)
    with pytest.raises(ValueError, match="Tk multiples of 8"):
        pwa.check_k5_shapes(torch.bfloat16, Tq, Tk + 4, 32)
    if Tq % 8:
        qj = jax.ShapeDtypeStruct((G, Tq, H * 32), np.float32)
        kj = jax.ShapeDtypeStruct((G, Tk, H * 32), np.float32)
        assert not jwa._packed_bwd_pallas_ok(qj, kj, None, None, H)


@pytest.mark.parametrize("Tq,pitch", [(600, 600), (100, 100), (625, 628),
                                      (1, 4), (1024, 1024), (63, 64)])
def test_statistics_rows_start_on_16_bytes(Tq, pitch):
    """The (3, G, H, pitch) f32 statistics scratch that K1 writes and K5
    reads through TMA: rows Tq rounded up to 4 floats apart (TMA's strides
    are multiples of 16 bytes), the same as Tq wherever Tq % 4 == 0, so the
    CorpBEVT and LiDAR shapes keep their layout."""
    assert pwa.stats_pitch(Tq) == pitch and pitch * 4 % 16 == 0
    stats = pwa.stats_scratch(2, 3, Tq, "cpu")
    assert stats.shape == (3, 2, 3, pitch) and stats.dtype == torch.float32
