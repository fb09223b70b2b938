"""The benchmark's work counts on the CPU, and phase 3's bounds.

* A ``--device cpu`` eval row and train row carry the counts of a frame or
  step (``flops_per_*``, ``bytes_per_*``, the work by kernel op) with null
  shares of the peaks: a CPU run gives no device rate.  The step's count
  holds its backward.
* ``chip_smoke.py``'s phase 3 takes every bound from ``utils/flops.py``'s
  work formulas.  Computed here at the shapes of its rows (meta tensors
  standing for the row's operands), they equal what the formulas of
  ``chip_smoke.py`` gave before they moved (``BEFORE`` below): the sums of
  operations and of bound ms over each kernel's rows in each dtype, and the
  bound of the kernels line (bf16 rows times their launches a frame, step
  or pass), which the last card run before the move printed (NVIDIA H100
  80GB HBM3, 700 W).  K4's "encoder_unmasked" row has no mask and no longer
  counts one (20,480 bytes); its bound is its operations', unchanged.
"""

import pytest
import torch

import chip_smoke as cs
from cobevt_tpu_torch.tools import benchmark
from cobevt_tpu_torch.tools.micro_bn_stats import SHAPES as BN_SHAPES
from cobevt_tpu_torch.utils import flops
from tests.test_corpbevt_parity import our_config
from tests.test_torch_train_step import dryrun_config, port_config

CPU = torch.device("cpu")
SHARES = ("mfu", "hbm_util", "hbm_gbs")


def test_cpu_rows_carry_counts_and_null_shares():
    cfg = port_config(dryrun_config())
    model, batch, _ = benchmark.build_corpbevt(config=cfg)
    opt = benchmark.parse_args(["--iters", "1", "--warmup", "2", "--fp32"])
    row = benchmark.measure_eval(model, "corpbevt", batch, opt, CPU)
    assert row["flops_per_frame"] > 1e8 and row["bytes_per_frame"] > 1e6
    assert all(row[k] is None for k in SHARES)
    assert "hbm_flag" not in row and "int8_ops_per_frame" not in row
    assert row["kernel_work"]["conv3x3"]["calls"] > 0
    # the counted frame is a warmup frame: the timed frames' launches and
    # the count of frames do not change
    assert row["iters"] == 1

    train = benchmark.parse_args(["--train", "--iters", "1", "--warmup", "1",
                                  "--fp32"])
    step = benchmark.measure_train(model.train(), "corpbevt", batch, train,
                                   CPU)
    assert step["steps"] == 2
    assert all(step[k] is None for k in SHARES)
    # forward, backward (about twice the forward) and the update
    assert step["flops_per_step"] > 2.5 * row["flops_per_frame"]
    assert step["bytes_per_step"] > row["bytes_per_frame"]


def test_int8_row_counts_its_int8_products(monkeypatch):
    """Under COBEVT_INT8=1 at widths that take K7 (C >= 256), the row
    splits out the int8 products."""
    monkeypatch.setenv("COBEVT_INT8", "1")
    cfg = port_config(our_config())
    model, batch, _ = benchmark.build_corpbevt(config=cfg)
    opt = benchmark.parse_args(["--iters", "1", "--warmup", "1", "--fp32"])
    row = benchmark.measure_eval(model, "corpbevt", batch, opt, CPU)
    assert 0 < row["int8_ops_per_frame"] < row["flops_per_frame"]
    assert row["kernel_work"]["conv3x3_int8"]["calls"] > 0
    assert row["mfu"] is None


# ---------------------------------------------------------------------------
# phase 3's bounds
# ---------------------------------------------------------------------------

def _meta(*shape, dt):
    return torch.empty(*shape, dtype=dt, device="meta")


def phase3_rows():
    """(kernel, case, dtype name, (operations, bytes), peak) of every row
    of phase 3, from utils/flops.py at the row's operand shapes."""
    f32, i8 = torch.float32, torch.int8
    for dtype in (torch.float32, torch.bfloat16):
        dn, ds = str(dtype).split(".")[-1], dtype.itemsize

        def T(*shape, dt=dtype):
            return _meta(*shape, dt=dt)

        for c in cs.K1_CASES + cs.K1_SINBEVT_CASES + cs.K1_NUSC_CASES:
            name, G, Tq, Tk, bias, mask, weight = c[:7]
            H = c[9]
            C = H * cs.K1_HEAD_DIM
            yield "K1", name, dn, flops.k1_work(
                T(G, Tq, C), T(G, Tk, C), T(G, Tk, C), H,
                T(Tq, H * Tk, dt=f32) if bias else None,
                T(G, Tk, dt=f32) if mask else None,
                T(G, Tq, H * Tk) if weight else None), dn
        for c in cs.K3_CASES + cs.K3_SINBEVT_CASES:
            _, N, H, W, C, res = c[:6]
            x = T(N, H, W, C)
            yield "K3", c[0], dn, flops.k3_work(
                x, T(3, 3, C, C), T(C, dt=f32), x if res else None), dn
        for c in cs.K7_CASES:
            _, N, H, W, C, res = c[:6]
            x = T(N, H, W, C)
            yield "K7", c[0], dn, flops.k7_work(
                x, T(C, 9 * C, dt=i8), T(C, dt=f32), T(C, dt=f32),
                x if res else None), "int8"
        for name, shape, _ in cs.A7_CASES:
            yield "A7", name, dn, flops.a7_work(
                T(*shape), T(1, dt=torch.int32)), "float32"
        for name, (N, H, W, C), res, leaves, _ in cs.S8_CASES:
            xq = T(N, H, W, C, dt=i8)
            yield "S8", name, dn, flops.s8_work(
                xq, T(C, 9 * C, dt=i8), T(C, dt=f32), T(C, dt=f32),
                xq if res else None, ds if leaves else 1), "int8"
        for (R, C), name in BN_SHAPES:
            yield "K9", name, dn, flops.bn_stats_work(R, C, 1, ds), "float32"
            yield "K10", name, dn, flops.bn_stats_work(R, C, 2, ds), \
                "float32"
        for B in (cs.K2_B, cs.K2_SINBEVT_B):
            for c in cs.K2_CASES:
                _, H, h, qw, kw, embed, _, _ = c
                name = c[0] if B == cs.K2_B else f"sinbevt_{c[0]}"
                yield "K2", name, dn, flops.k2_work(
                    B, cs.K2_CAMS, H, H, h, h, (qw, qw), (kw, kw), cs.K2_DIM,
                    cs.K2_DIM, 2 * cs.K2_DIM, embed, ds), dn
        for B in cs.K2_NUSC_BATCHES:
            for c in cs.K2_NUSC_CASES:
                name, H, (h, w), qw, kw, D, _, embed, _, _ = c
                name = name if B == 1 else f"{name}_b{B}"
                yield "K2", name, dn, flops.k2_work(
                    B, cs.K2_NUSC_CAMS, H, H, h, w, qw, kw, D, D, 2 * D,
                    embed, ds), dn
        for name, masked, _, _ in cs.K4_CASES:
            # CorpBEVT's encoder (k4_inputs): (1, 5, 32, 32, 128), window
            # 8, 4 heads, depth 3, mlp 256, the bias in the compute dtype
            yield "K4", name, dn, flops.fusion_work(
                1, 5, 32, 32, 128, 8, 4, 3, 256, ds, ds, masked), dn
        for c in cs.K6_CASES:
            yield "K6", c[0], dn, flops.fusion_work(*c[1], ds, 4), dn
        for c in cs.K5_CASES + cs.K5_NUSC_CASES:
            name, G, Tq, Tk, bias, mask = c[:6]
            H = c[7] if len(c) > 7 else cs.K1_HEADS
            C = H * cs.K1_HEAD_DIM
            q = T(G, Tq, C)
            yield "K5", name, dn, flops.k5_work(
                q, T(G, Tk, C), T(G, Tk, C), q, q, H,
                T(Tq, H * Tk, dt=f32) if bias else None,
                T(G, Tk, dt=f32) if mask else None), dn
        for name, N, D, M, _ in cs.FFD_CASES:
            x, v_d, v_m = T(N, D), T(D, dt=f32), T(M, dt=f32)
            w1, w2 = T(D, M), T(M, D)
            yield "K11", name, dn, flops.k11_work(x, v_d, v_d, w1, v_m, w2,
                                                  v_d), dn
            yield "K12", name, dn, flops.k12_work(x, x, v_d, v_d, w1, v_m,
                                                  w2), dn
        for name, G, Tq, Tk, bias, mask in cs.K8_CASES:
            q = T(G, cs.K1_HEADS, Tq, cs.K1_HEAD_DIM)
            k = T(G, cs.K1_HEADS, Tk, cs.K1_HEAD_DIM)
            yield "K8", name, dn, flops.k8_work(
                q, k, k, T(cs.K1_HEADS, Tq, Tk, dt=f32) if bias else None,
                T(G, Tk, dt=f32) if mask else None), dn


# (rows, sum of operations, sum of bound ms, rows bound by bytes) of each
# kernel in each dtype, from the formulas chip_smoke.py held before they
# moved to utils/flops.py
BEFORE = {
    ("K1", "float32"): (21, 140446396416.0, 2.096214871880597, 0),
    ("K3", "float32"): (12, 173946175488.0, 2.596211574447762, 0),
    ("K7", "float32"): (4, 96636764160.0, 0.05606968689810171, 2),
    ("A7", "float32"): (2, 7864320.0, 0.009390235223880597, 2),
    ("S8", "float32"): (4, 78847672320.0, 0.07385821611940298, 4),
    ("K9", "float32"): (4, 1141227520.0, 0.3406668417910448, 4),
    ("K10", "float32"): (4, 2282455040.0, 0.6813317731343284, 4),
    ("K2", "float32"): (24, 225847074816.0, 3.370851862925373, 0),
    ("K4", "float32"): (4, 52479131648.0, 0.7832706216119403, 0),
    ("K6", "float32"): (6, 1906248253440.0, 28.45146646925373, 0),
    ("K5", "float32"): (14, 331017011200.0, 4.940552405970148, 0),
    ("K11", "float32"): (2, 44422922240.0, 0.6630286901492537, 0),
    ("K12", "float32"): (2, 111057305600.0, 1.6575717253731341, 0),
    ("K8", "float32"): (3, 46472888320.0, 0.6936251988059701, 0),
    ("K1", "bfloat16"): (21, 140446396416.0, 0.2713550680854172, 18),
    ("K3", "bfloat16"): (12, 173946175488.0, 0.17588086500303338, 0),
    ("K7", "bfloat16"): (4, 96636764160.0, 0.048831108721576554, 0),
    ("A7", "bfloat16"): (2, 7864320.0, 0.00469511880597015, 2),
    ("S8", "bfloat16"): (4, 78847672320.0, 0.06133790567164179, 4),
    ("K9", "bfloat16"): (4, 1141227520.0, 0.170334376119403, 4),
    ("K10", "bfloat16"): (4, 2282455040.0, 0.3406668417910448, 4),
    ("K2", "bfloat16"): (24, 225847074816.0, 0.24678659570547667, 6),
    ("K4", "bfloat16"): (4, 52479131648.0, 0.05306282269767442, 0),
    ("K6", "bfloat16"): (6, 1906248253440.0, 1.92745020570273, 0),
    ("K5", "bfloat16"): (14, 331017011200.0, 0.4607451404397628, 11),
    ("K11", "bfloat16"): (2, 44422922240.0, 0.044977205484810524, 1),
    ("K12", "bfloat16"): (2, 111057305600.0, 0.11230920595083228, 1),
    ("K8", "bfloat16"): (3, 46472888320.0, 0.07123494208955225, 3),
}
# bound_ms of the kernels line of the parent's card run (NVIDIA H100 80GB
# HBM3, 700 W), before the formulas moved
KERNELS_LINE = {
    "K1": 0.0065731629850746265, "K2": 0.13028212222446917,
    "K3": 0.48855795834175936, "K4": 0.013265705674418605,
    "K5": 0.2385820633536061, "K6": 0.4724762588796764,
    "K7": 0.17090888052551795, "A7": 0.00469511880597015,
    "S8": 0.1002294256716418, "K8": 0.07123494208955225,
    "K9": 0.17033437611940297, "K10": 0.3406668417910448,
    "K11": 0.044784479514661274, "K12": 0.11196119878665318,
}


def _per_frame():
    """Launches a frame, step or pass of each bf16 row of the kernels line
    (its ``per_frame`` field)."""
    pf = {}
    for c in cs.K1_CASES + cs.K1_SINBEVT_CASES + cs.K1_NUSC_CASES:
        pf["K1", c[0]] = c[8]
    for c in cs.K3_CASES + cs.K3_SINBEVT_CASES:
        pf["K3", c[0]] = c[6]
    for c in cs.K7_CASES:
        pf["K7", c[0]] = c[6]
    for name, _, n in cs.A7_CASES:
        pf["A7", name] = n
    for c in cs.S8_CASES:
        pf["S8", c[0]] = c[4]
    for c in cs.K4_CASES:
        pf["K4", c[0]] = c[3]
    for c in cs.K6_CASES:
        pf["K6", c[0]] = c[4]
    for c in cs.K5_CASES + cs.K5_NUSC_CASES:
        pf["K5", c[0]] = c[6]
    for c in cs.FFD_CASES:
        pf["K11", c[0]] = pf["K12", c[0]] = c[4]
    return pf


def test_phase3_bounds_are_those_of_pr22():
    got = {}
    line = {}
    per_frame = _per_frame()
    for kernel, case, dn, (ops_, nbytes), peak in phase3_rows():
        b = flops.bound(ops_, nbytes, peak)
        n, s_ops, s_bound, by_bytes = got.get((kernel, dn), (0, 0.0, 0.0, 0))
        got[kernel, dn] = (n + 1, s_ops + ops_, s_bound + b["bound_ms"],
                           by_bytes + (b["bound_by"] == "bytes"))
        if dn != "bfloat16":
            continue
        # the CorpBEVT K2 rows (B 5) count once a frame; K8, K9, K10 once
        # a shape
        if kernel == "K2":
            n_frame = int(case in {c[0] for c in cs.K2_CASES})
        elif kernel in ("K8", "K9", "K10"):
            n_frame = 1
        else:
            n_frame = per_frame[kernel, case]
        line[kernel] = line.get(kernel, 0.0) + b["bound_ms"] * n_frame
    assert set(got) == set(BEFORE)
    for key, (n, s_ops, s_bound, by_bytes) in BEFORE.items():
        assert got[key][0] == n and got[key][3] == by_bytes, key
        assert got[key][1] == s_ops, key
        assert got[key][2] == pytest.approx(s_bound, rel=1e-12), key
    for kernel, want in KERNELS_LINE.items():
        assert line[kernel] == pytest.approx(want, rel=1e-12), kernel
