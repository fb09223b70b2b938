"""The serving export of the port (``tools/export_serving.py``) and the
``cobevt::`` custom ops it needs.

The export of the tiny CorpBEVT under the "stock" switch setting (the cases
and the model in ``tests/torch_export_cases.py``; "fused" and the int8
frame in ``tests/test_torch_export_serving_fused.py``); the CLI on a
one-op model; then ``torch.library.opcheck`` on every op at a small CPU
shape (``ops/op_samples.py``), K7's and the absmax's written slots
included, and the ops' routing rules.
"""

import os

import pytest
import torch
from torch.library import opcheck

from cobevt_tpu_torch import ops
from cobevt_tpu_torch.ops import conv2d, dispatch
from cobevt_tpu_torch.ops.op_samples import sample_args
from cobevt_tpu_torch.tools import export_serving
from tests.torch_export_cases import (  # noqa: F401 (collected by pytest)
    exported_fixture,
    models,
    test_another_agent_count_raises,
    test_graph_holds_one_op_per_wrapper_call,
    test_loaded_program_matches_jax_and_the_live_forward,
)

exported = exported_fixture("stock")


class _OneConv(torch.nn.Module):
    """A K3 call as a model: the CLI's plumbing without a CorpBEVT trace."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.randn(3, 3, 16, 8) * 0.1)
        self.shift = torch.nn.Parameter(torch.zeros(8))

    def forward(self, batch):
        return {"y": ops.fused_conv3x3(batch["x"], self.w, self.shift)}


def test_cli_exports_loads_and_runs(tmp_path, monkeypatch, capsys):
    """``main`` with ``--synthetic`` (a one-op model in place of the
    benchmark's): the file written, loaded back, run once, and the JAX
    tool's JSON line."""
    import json

    batch = {"x": torch.randn(1, 4, 4, 16)}
    monkeypatch.setattr(export_serving, "synthetic_model",
                        lambda name, max_cav, device: (_OneConv(), batch))
    out = str(tmp_path / "cli.pt2")
    summary = export_serving.main(["--synthetic", "corpbevt", "--out", out,
                                   "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == summary
    assert summary["bytes"] == os.path.getsize(out) and \
        summary["device"] == "cpu"
    assert summary["outputs"] == {"y": [1, 4, 4, 8]}
    program = export_serving.load_exported(out)
    assert export_serving.cobevt_nodes(program) == {"conv3x3": 1}


@pytest.mark.parametrize("name", sorted(ops.KERNEL_OPS))
def test_opcheck(name):
    """Schema, fake implementation (shape, dtype, device), the written
    arguments and the traced graph of each op on the CPU."""
    args = sample_args("cpu")[name]
    opcheck(ops.KERNEL_OPS[name].custom_op, args)


def test_written_slots_hold_the_plain_fold():
    """K7 writes its output's |max| into ``out_amax`` and the absmax its
    input's into ``slot``, through the ops as through the plain version."""
    x, wt, s_w, shift, amax, res, relu, out_amax = \
        sample_args("cpu")["conv3x3_int8"]
    out = ops.KERNEL_OPS["conv3x3_int8"](x, wt, s_w, shift, amax, res, relu,
                                         out_amax)
    want = conv2d.fold_amax_(torch.zeros_like(out_amax), out)
    assert torch.equal(out_amax, want) and int(want) != 0
    slot = torch.zeros_like(out_amax)
    ops.KERNEL_OPS["int8_absmax"](x, slot)
    assert torch.equal(slot, amax)


def test_wrappers_route_through_the_ops(monkeypatch):
    """Without a gradient a wrapper calls its op on a CPU tensor; "torch"
    asked for by name runs the plain version inline; a CPU operand that
    needs a gradient runs the plain version inline; "kernel" on a CPU
    tensor raises.  No CPU call counts a launch."""
    calls = []
    real = dispatch.KernelOp.__call__
    monkeypatch.setattr(dispatch.KernelOp, "__call__",
                        lambda self, *a: calls.append(self.name) or
                        real(self, *a))
    q, k, v, H, bias, mask, _, _ = sample_args("cpu")[
        "window_attention_packed"]
    ops.reset_launch_counts()
    with torch.no_grad():
        a = ops.fused_window_attention_packed(q, k, v, H, bias, mask)
        b = ops.fused_window_attention_packed(q, k, v, H, bias, mask,
                                              impl="torch")
        with dispatch.forced_impl("torch"):
            c = ops.fused_window_attention_packed(q, k, v, H, bias, mask)
    assert calls == ["window_attention_packed"]
    assert torch.equal(a, b) and torch.equal(a, c)
    qg = q.clone().requires_grad_()
    ops.fused_window_attention_packed(qg, k, v, H, bias, mask).sum().backward()
    assert calls == ["window_attention_packed"] and qg.grad is not None
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_window_attention_packed(q, k, v, H, bias, mask,
                                          impl="kernel")
    assert all(n == 0 for n in ops.launch_counts().values())


def test_pack_cache_builds_without_keeping_under_tracing():
    cache = dispatch.PackCache()
    built = []

    def get(name, t):
        def build():
            built.append(name)
            return t * 2
        return cache.get(name, [t], build)

    w = torch.randn(4)
    assert torch.equal(get("a", w), w * 2)
    get("a", w)
    assert built == ["a"]                        # cached on real tensors
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fw = mode.from_tensor(w)
        get("b", fw)
        get("b", fw)
    assert built == ["a", "b", "b"] and "b" not in cache._entries
