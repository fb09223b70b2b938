"""The port's work counts (``cobevt_tpu_torch/utils/flops.py``) on the CPU.

* Every kernel's registered formula equals ``FlopCounterMode``'s count of
  its plain version run inline (the op samples of ``ops/op_samples.py``;
  K9-K12, which have no op, at small shapes): counting through the op and
  through the plain version gives the same products, exactly.
* A tiny CorpBEVT eval frame (tests/test_corpbevt_parity.py's config) counts
  the same FLOPs through the ``cobevt::`` ops as on ``forced_impl("torch")``,
  in both switch settings, exactly.
* The same frame against the products of the JAX package's forward, counted
  here from its jaxpr (``dot_general``, ``conv_general_dilated``) after
  dead-code elimination, as XLA compiles it: on the stock path to 1e-6
  relative once the one difference that is no kernel's is taken out (JAX
  expands SelfAttention's relative-position bias by products with one-hot
  constants, the port by a gather); on the fused path every product outside
  K2 and K4 to 1e-6, and the two kernels named with their gaps: K2's
  XLA composite projects each camera's output before the camera mean, the
  TPU body (and the port) after it, which the test computes; K4's JAX
  fallback on the CPU runs the TPU body's block-diagonal heads (every
  head's scores over all heads' keys) and expands its bias every call,
  which the test bounds.
* A tiny train step (the dry-run config's loss, forward and backward)
  against the products of ``jax.grad`` of the JAX loss: the forward to
  1e-6 (SelfAttention's bias expansion out, as above), and with the
  backward everything but the window attention to 1e-6; the attention's
  gap (the port's K1 forward, K5 plain version and composite backward
  against the JAX custom VJP's XLA branch) is named and bounded.  A
  strided convolution's input gradient counts the products of its
  nonzero taps on both sides.
* ``mfu``, ``hbm_util`` and ``utilization`` equal the JAX functions' under
  the same ``COBEVT_PEAK_*`` overrides, and a card's name that the tables
  do not hold gives None, as JAX's unknown devices do.
"""

import linecache

import numpy as np
import pytest
import jax
import torch
from jax.extend import core as jcore
from jax.interpreters import partial_eval as pe
from torch.utils.flop_counter import FlopCounterMode

from cobevt_tpu.models.corpbevt import CorpBEVT as JaxCorpBEVT
from cobevt_tpu.utils import flops as jax_flops
from cobevt_tpu_torch import ops
from cobevt_tpu_torch.models.corpbevt import CorpBEVT
from cobevt_tpu_torch.ops import bn_stats, ffd_fused
from cobevt_tpu_torch.ops.op_samples import sample_args
from cobevt_tpu_torch.tools.micro_ffd_fused import make_operands
from cobevt_tpu_torch.utils import flops
from tests.test_corpbevt_parity import our_config
from tests.test_torch_corpbevt import make_batch, port_config
from tests.torch_parity import jax_variables, jnp_tree, port_from

REL = 1e-6


def plain_products(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("name", sorted(ops.KERNEL_OPS))
def test_registered_formula_equals_the_plain_products(name):
    args = sample_args("cpu")[name]
    op = ops.KERNEL_OPS[name]
    # the function the op was made from: its plain version
    want = plain_products(op.custom_op._init_fn, *args)
    counted = flops.costs(op, *args)
    assert counted["flops"] == want
    assert counted["kernels"][name]["calls"] == 1
    work, nbytes = op.work(*args)
    assert counted["kernels"][name]["bytes"] == nbytes > 0
    if op.products:
        assert work == want > 0
        assert counted["int8_ops"] == (want if op.products == "int8" else 0)
    else:
        # the absmax does compares, no products
        assert want == 0 and work > 0


def test_micro_kernel_formulas_equal_the_plain_products():
    """K9-K12 have no model path and no op; their formulas still hold the
    plain versions' products (none for K9 and K10)."""
    N, D, M = 80, 32, 64
    x, gamma, beta, w1, b1, w2, b2 = make_operands(N, D, M, torch.float32,
                                                   "cpu")
    dy = torch.randn(N, D, generator=torch.Generator().manual_seed(0))
    assert plain_products(ffd_fused.ffd_reference, x, gamma, beta, w1, b1,
                          w2, b2) == flops.k11_work(
                              x, gamma, beta, w1, b1, w2, b2)[0]
    assert plain_products(ffd_fused.ffd_backward_reference, x, dy, gamma,
                          beta, w1, b1, w2) == flops.k12_work(
                              x, dy, gamma, beta, w1, b1, w2)[0]
    assert plain_products(bn_stats.bn_stats_fwd_reference, x, -1e30) == 0
    assert plain_products(bn_stats.bn_stats_bwd_reference, dy, x, -1e30) \
        == 0
    assert flops.bn_stats_work(N, D, 2, 4) == (4.0 * N * D * 2,
                                               2 * N * D * 4 + 8 * D)


# ---------------------------------------------------------------------------
# the tiny CorpBEVT frame
# ---------------------------------------------------------------------------

SWITCHES = {"stock": {"COBEVT_FUSED_XATTN": "0", "COBEVT_FUSED_FUSION": "0"},
            "fused": {"COBEVT_FUSED_XATTN": None,
                      "COBEVT_FUSED_FUSION": "force"}}


@pytest.fixture(params=sorted(SWITCHES))
def switches(request, monkeypatch):
    for k, v in SWITCHES[request.param].items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    return request.param


@pytest.fixture(scope="module")
def frame():
    """(JAX module, its variables, the port holding them, a batch of 3 live
    agents)."""
    jm = JaxCorpBEVT(our_config())
    v = jax_variables(jm, jnp_tree(make_batch(3)), False, seed=3)
    port = port_from(CorpBEVT(port_config(our_config())), v)
    return jm, v, port, make_batch(3, seed=3)


def port_costs(port, batch, impl=None):
    """The frame's counts on a warm call (the packed weights built by the
    call before), as the benchmark counts its last warmup frame."""
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    with torch.no_grad():
        if impl is None:
            port(tb)
            return flops.costs(port, tb)
        with ops.forced_impl(impl):
            port(tb)
            return flops.costs(port, tb)


def _frames(eqn):
    tb = eqn.source_info.traceback
    return [f for f in (tb.frames if tb is not None else ())
            if "cobevt_tpu/" in f.file_name.replace("\\", "/")]


def eqn_products(eqn) -> float:
    """2 x multiply-adds of a dot_general or conv_general_dilated, as XLA's
    cost analysis counts them, but for the zeros a dilated input inserts:
    the transpose of a strided convolution (its input gradient) multiplies
    1 / prod(lhs_dilation) of its taps by data, as ``FlopCounterMode``
    counts the input gradient (the forward convolution's products)."""
    name = eqn.primitive.name
    if name == "dot_general":
        (lc, _), _ = eqn.params["dimension_numbers"]
        lhs = eqn.invars[0].aval.shape
        return 2.0 * np.prod(eqn.outvars[0].aval.shape, dtype=np.float64) * \
            np.prod([lhs[i] for i in lc], dtype=np.float64)
    if name == "conv_general_dilated":
        rhs = eqn.invars[1].aval.shape
        spec = eqn.params["dimension_numbers"].rhs_spec
        return 2.0 * np.prod(eqn.outvars[0].aval.shape, dtype=np.float64) * \
            rhs[spec[1]] * np.prod([rhs[i] for i in spec[2:]],
                                   dtype=np.float64) / \
            np.prod(eqn.params["lhs_dilation"], dtype=np.float64)
    return 0.0


def jaxpr_products(jaxpr, classify, out=None):
    """Products of every equation (sub-jaxprs included, a scan's body times
    its length), summed by ``classify(eqn)``."""
    out = {} if out is None else out
    for e in jaxpr.eqns:
        n = eqn_products(e)
        if n:
            key = classify(e)
            out[key] = out.get(key, 0.0) + n
        for k, v in e.params.items():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                j = sub.jaxpr if isinstance(sub, jcore.ClosedJaxpr) else sub
                if not isinstance(j, jcore.Jaxpr):
                    continue
                if e.primitive.name.startswith("custom_vjp") and \
                        k not in ("call_jaxpr", "fun_jaxpr"):
                    continue
                if e.primitive.name == "custom_jvp_call" and \
                        k != "call_jaxpr":
                    continue
                reps = e.params.get("length", 1) \
                    if e.primitive.name == "scan" else 1
                for key, m in jaxpr_products(j, classify).items():
                    out[key] = out.get(key, 0.0) + reps * m
    return out


def classify(eqn) -> str:
    """Whose products an equation is: "K2" (the JAX fused_cross_attention),
    "K4" (the JAX fused_swap_fusion), "fusion_bias" (the fusion's one-hot
    bias expansion, which the port runs too), "self_attn_bias"
    (SelfAttention's one-hot bias expansion), else "rest"."""
    for f in _frames(eqn):
        path = f.file_name.replace("\\", "/")
        if path.endswith("cobevt_tpu/ops/fused_cross_attention.py"):
            return "K2"
        if path.endswith("cobevt_tpu/ops/fused_swap_fusion.py"):
            return "K4"
        if f.function_name == "expand_bias_flat":
            return "fusion_bias"
        if path.endswith("cobevt_tpu/models/fax.py") and "bias5 = " in \
                linecache.getline(f.file_name, f.line_num):
            return "self_attn_bias"
    return "rest"


def jax_products(jm, v, batch) -> dict:
    # the package's jitted pieces read the switches when traced
    jax.clear_caches()
    closed = jax.make_jaxpr(lambda v_, b: jm.apply(v_, b, False))(
        v, jnp_tree(batch))
    # XLA drops dead code (the unused static head of a dynamic model)
    jaxpr, _ = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    return jaxpr_products(jaxpr, classify)


def test_frame_counts_the_same_on_the_ops_and_the_plain_path(frame,
                                                             switches):
    _, _, port, batch = frame
    kernel = port_costs(port, batch)
    plain = port_costs(port, batch, "torch")
    assert kernel["flops"] == plain["flops"] > 1e9
    assert plain["kernels"] == {}
    calls = {k: r["calls"] for k, r in kernel["kernels"].items()}
    if switches == "stock":
        assert calls == {"conv3x3": 6, "window_attention_packed": 11}
    else:
        assert calls == {"conv3x3": 6, "window_attention_packed": 1,
                         "cross_view_attention": 6, "swap_fusion": 1}
    # the fused frame moves fewer logical bytes than its plain twin
    assert kernel["bytes"] < plain["bytes"] or switches == "stock"


def test_frame_counts_the_jax_forwards_products(frame, switches):
    jm, v, port, batch = frame
    got = port_costs(port, batch)
    want = jax_products(jm, v, batch)
    tally = {k: r["ops"] for k, r in got["kernels"].items()}
    if switches == "stock":
        # the fusion's bias expansion runs every call on both sides
        assert set(want) == {"rest", "fusion_bias", "self_attn_bias"}
        assert got["flops"] == pytest.approx(
            want["rest"] + want["fusion_bias"], rel=REL)
        return
    # products outside K2 and K4 (the self-attention's K1 included)
    rest = got["flops"] - tally["cross_view_attention"] - tally["swap_fusion"]
    assert rest == pytest.approx(want["rest"], rel=REL)
    # K2: the XLA composite projects each of the M cameras' outputs before
    # their mean; the port, as the TPU body, after it.  One branch a frame
    # carries the cameras (stage 0's local branch, the BEV embedding), over
    # every agent's map at half the BEV width
    cfg = our_config()
    agents, cams, side = 4, 2, cfg.fax.bev_height // cfg.fax.upsample_scales[0]
    D = C = cfg.fax.dim[0]
    gap = 2.0 * agents * (cams - 1) * side * side * C * D
    assert want["K2"] - tally["cross_view_attention"] == gap
    # K4: the JAX fallback runs the TPU body's block-diagonal heads, so its
    # score and value products are at most `heads` times the port's; it
    # expands its bias every call, where the port packs it with the weights
    heads = cfg.fax.dim[-1] // cfg.fusion_dim_head
    assert tally["swap_fusion"] < want["K4"] <= heads * tally["swap_fusion"]
    assert want["fusion_bias"] > 0


# ---------------------------------------------------------------------------
# a tiny train step
# ---------------------------------------------------------------------------

def test_train_step_counts_the_jax_gradients_products():
    """Forward and backward of the dry-run config's loss (B 2, train mode)
    against the products of ``jax.grad`` of the JAX loss.  The forward
    equals JAX's to 1e-6 once SelfAttention's one-hot bias expansion is
    out (the port gathers).  With the backward, one kernel's count differs
    and is named: the window attention, K1's forward with K5's plain
    version and the composite backward in the port against the JAX custom
    VJP's XLA branch, which the test measures on both sides and bounds at
    5% of the port's attention products; everything else equals JAX's to
    1e-6."""
    from cobevt_tpu_torch.ops import window_attention as pwa
    from tests.test_torch_train_step import (
        JaxSegLoss, VanillaSegLoss, dryrun_config, make_batch)
    from tests.test_torch_train_step import port_config as step_config

    jcfg = dryrun_config()
    jm = JaxCorpBEVT(jcfg)
    batch = make_batch()
    jbatch = jnp_tree(batch)
    v = jax_variables(jm, jbatch, False, seed=3)
    seg = JaxSegLoss(target="dynamic", d_weights=75.0, d_coe=2.0)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]}, jbatch, True,
                          mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
        return seg(out, {"gt_dynamic": jbatch["gt_dynamic"],
                         "gt_static": jbatch["gt_dynamic"]})[0]

    def attention_apart(eqn):
        for f in _frames(eqn):
            if f.file_name.replace("\\", "/").endswith(
                    "cobevt_tpu/ops/window_attention.py"):
                return "attention"
        return classify(eqn)

    def counted(fn):
        jax.clear_caches()
        closed = jax.make_jaxpr(fn)(v["params"])
        jaxpr, _ = pe.dce_jaxpr(closed.jaxpr,
                                [True] * len(closed.jaxpr.outvars))
        return jaxpr_products(jaxpr, attention_apart)

    want_fwd, want = counted(loss_fn), counted(jax.grad(loss_fn))

    port = port_from(CorpBEVT(step_config(jcfg)), v).train()
    tb = {k: torch.from_numpy(a) for k, a in batch.items()}
    pseg = VanillaSegLoss(target="dynamic", d_weights=75.0, d_coe=2.0)

    def loss():
        return pseg(port(tb), {"gt_dynamic": tb["gt_dynamic"],
                               "gt_static": tb["gt_dynamic"]})[0]

    with torch.no_grad():
        fwd = flops.costs(loss)["flops"]
    assert fwd == pytest.approx(
        sum(want_fwd.values()) - want_fwd["self_attn_bias"], rel=REL)

    # the port's attention products, forward and backward, measured apart
    attention = [0]
    names = ("packed_attention_reference", "packed_backward_reference",
             "packed_backward_composite")
    real = {n: getattr(pwa, n) for n in names}

    def measured(fn):
        def wrapped(*args, **kwargs):
            with FlopCounterMode(display=False) as inner:
                out = fn(*args, **kwargs)
            attention[0] += inner.get_total_flops()
            return out
        return wrapped

    try:
        for n in names:
            setattr(pwa, n, measured(real[n]))
        got = flops.costs(lambda: loss().backward())["flops"]
    finally:
        for n in names:
            setattr(pwa, n, real[n])
    assert attention[0] > 0 and want["attention"] > 0
    rest = sum(want.values()) - want["attention"] - want["self_attn_bias"]
    assert got - attention[0] == pytest.approx(rest, rel=REL)
    assert 0 <= want["attention"] - attention[0] <= 0.05 * attention[0]


# ---------------------------------------------------------------------------
# shares of the peaks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tflops, gbs", [("989", "3350"), ("197", "819")])
@pytest.mark.parametrize("flop, nbytes, seconds", [
    (2.5e12, 1.2e9, 0.01), (7.7e9, 3.1e12, 0.5), (1e9, None, 0.002),
    (None, 4.0e9, 0.001), (3e9, 2e9, 0.0)])
def test_utilization_equals_the_jax_functions(monkeypatch, tflops, gbs,
                                              flop, nbytes, seconds):
    monkeypatch.setenv("COBEVT_PEAK_TFLOPS", tflops)
    monkeypatch.setenv("COBEVT_PEAK_HBM_GBS", gbs)
    costs = {"flops": flop, "bytes": nbytes}
    assert flops.mfu(flop, seconds) == jax_flops.mfu(flop, seconds)
    assert flops.hbm_util(nbytes, seconds) == jax_flops.hbm_util(nbytes,
                                                                 seconds)
    assert flops.utilization(costs, seconds) == jax_flops.utilization(
        costs, seconds)
    assert flops.device_peak_flops(int8=True) == \
        jax_flops.device_peak_flops(int8=True)


def test_peaks_by_card_name(monkeypatch):
    monkeypatch.delenv("COBEVT_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("COBEVT_PEAK_HBM_GBS", raising=False)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: flops.H100)
    assert flops.device_peak_flops(0) == 989e12
    assert flops.device_peak_flops(0, int8=True) == 1979e12
    assert flops.device_peak_hbm("cuda:0") == 3.35e12
    # the CPU, and a card the tables do not hold, have no peak
    assert flops.device_peak_flops("cpu") is None
    assert flops.mfu(1e12, 1.0, "cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert flops.device_peak_flops(0) is None
    assert flops.device_peak_hbm(0) is None
    assert flops.utilization({"flops": 1e9, "bytes": 1e9}, 0.1, 0) == {
        "mfu": None, "hbm_util": None, "hbm_gbs": 10.0}
