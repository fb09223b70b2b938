"""The port's trace-table CLI (``cobevt_tpu_torch/tools/parse_trace.py``)
attributes device time by module scope.

The four cases of ``tests/test_parse_trace.py`` (module aggregation, the
per-op table, the bandwidth report, the depth key) on a synthetic
``torch.profiler`` trace whose device events reach their host side through
correlated launches; and a CPU-only trace, a real one with the benchmark's
module scopes, exits 2.
"""

import gzip
import json

import torch

from cobevt_tpu_torch.tools import timing
from cobevt_tpu_torch.tools.parse_trace import (
    UNSCOPED,
    Attribution,
    device_events,
    find_trace_files,
    kernel_name,
    load_events,
    main,
    module_key,
    work_path,
)
from cobevt_tpu_torch.utils import flops

HOST, DEV = 100, 0


def _span(cat, name, ts, dur, tid=7, pid=HOST, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _span("cuda_runtime", name, ts, 2, correlation=corr)


def _device(cat, name, ts, dur, corr, **args):
    return _span(cat, name, ts, dur, tid=13, pid=DEV, correlation=corr,
                 **args)


# K3's bytes at x (1, 4, 4, 16), w (3, 3, 16, 8), shift (8,), residual
# (1, 4, 4, 8): what the work file beside the trace gives a call
K3_BYTES = flops.k3_work(torch.empty(1, 4, 4, 16), torch.empty(3, 3, 16, 8),
                         torch.empty(8), torch.empty(1, 4, 4, 8))[1]


def _events():
    return [
        {"ph": "M", "pid": DEV, "name": "process_name",
         "args": {"name": "GPU 0"}},
        # module scopes on the host thread, nested
        _span("user_annotation", "encoder/layer1_0", 0, 100),
        _span("user_annotation", "encoder/layer1_0/conv1", 1, 50),
        _span("user_annotation", "encoder/layer1_0/conv2", 60, 30),
        _span("user_annotation", "fax/stage0/attn", 110, 80),
        # torch's own annotation around the copy: no module scope
        _span("user_annotation", "Optimizer.step#AdamW.step", 195, 20),
        # the hand kernel's op call inside conv1, its two launches
        _span("cpu_op", "cobevt::conv3x3", 3, 40),
        _launch(10, 1),
        _launch(20, 2),
        # a library kernel in conv2, one in the attention, a copy after
        _launch(70, 3),
        _launch(120, 4),
        _launch(200, 5, "cudaMemcpyAsync"),
        # device events: 1.5 ms + 0.25 ms + 0.25 ms under layer1_0, 1 ms
        # under fax/stage0, and a copy of 1 GB in 0.5 ms outside any scope
        _device("kernel", "void conv3x3_wgmma_kernel<(int)2>(CUtensorMap)",
                1000, 1500, 1),
        _device("kernel", "void conv3x3_wgmma_kernel<(int)2>(CUtensorMap)",
                2600, 250, 2),
        _device("kernel", "void at::native::elementwise_kernel<128, 4>()",
                3000, 250, 3),
        _device("kernel", "void (anonymous namespace)::"
                "window_attention_kernel<float>(Args)", 3300, 1000, 4),
        _device("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 4400, 500,
                5, bytes=10 ** 9),
        # the device side of a scope repeats kernel time: never counted
        _span("gpu_user_annotation", "encoder/layer1_0", 1000, 2250, tid=13,
              pid=DEV),
    ]


def _write(tmp_path, events, name="host.pt.trace.json.gz", work=None):
    """The trace under ``tmp_path``, and ``work`` (the counted call's work
    by kernel op) beside it as the benchmark writes it."""
    d = tmp_path / "trace"
    d.mkdir(parents=True, exist_ok=True)
    with gzip.open(d / name, "wt") as f:
        json.dump({"traceEvents": events}, f)
    if work is not None:
        with open(work_path(str(d / name)), "w") as f:
            json.dump({"kernels": work}, f)
    return str(tmp_path)


K3_WORK = {"conv3x3": {"calls": 1, "ops": 36864.0, "bytes": K3_BYTES}}


def test_module_aggregation(tmp_path, capsys):
    root = _write(tmp_path, _events())
    files = find_trace_files(root)
    assert len(files) == 1
    events = load_events(files[0])
    assert len(device_events(events)) == 5
    attr = Attribution(events)
    scopes = [attr.scope(e) for e in device_events(events)]
    assert scopes == ["encoder/layer1_0/conv1", "encoder/layer1_0/conv1",
                      "encoder/layer1_0/conv2", "fax/stage0/attn", UNSCOPED]

    assert main([root, "--depth", "2", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device_total_ms"] == 3.5
    rows = {r["key"]: r for r in out["rows"]}
    assert rows["encoder/layer1_0"]["ms"] == 2.0
    assert rows["fax/stage0"]["ms"] == 1.0
    assert rows[UNSCOPED]["ms"] == 0.5
    assert abs(rows["encoder/layer1_0"]["pct"] - 57.14) < 0.01


def test_op_mode(tmp_path, capsys):
    root = _write(tmp_path, _events())
    assert main([root, "--by", "op", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    rows = {r["key"]: r for r in out["rows"]}
    assert rows["conv3x3_wgmma_kernel"]["ms"] == 1.75
    # the hand kernel's rows name the op that launched them
    assert rows["conv3x3_wgmma_kernel"]["ops"] == ["cobevt::conv3x3"]
    assert rows["elementwise_kernel"]["ops"] == []
    assert rows["window_attention_kernel"]["ms"] == 1.0
    assert rows["Memcpy HtoD"]["ms"] == 0.5


def test_bandwidth_report(tmp_path, capsys):
    root = _write(tmp_path, _events(), work=K3_WORK)
    assert main([root, "--bandwidth", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    k3_bytes = K3_BYTES
    assert k3_bytes == 6688
    assert out["leaf_device_ms"] == 3.5
    # bytes are known for the op call's two kernels and the copy
    assert out["counted_ms"] == 2.25
    assert out["bytes_gb"] == round((10 ** 9 + k3_bytes) / 1e9, 6)
    cats = {c["category"]: c for c in out["by_category"]}
    assert cats["cobevt::conv3x3"]["ms"] == 1.75
    assert cats["cobevt::conv3x3"]["gb"] == round(k3_bytes / 1e9, 6)
    # 1 GB in 0.5 ms: 2000 GB/s
    assert cats["Memcpy HtoD (Pageable -> Device)"]["gbs"] == 2000.0
    assert cats["other kernels"]["gb"] is None
    assert cats["other kernels"]["ms"] == 1.25
    assert out["unknown_ops"] == []
    # by kernel name, the op's bytes shared over its kernels by their time
    assert main([root, "--bandwidth", "--by", "op", "--json"]) == 0
    by_op = {c["category"]: c
             for c in json.loads(capsys.readouterr().out)["by_category"]}
    assert by_op["conv3x3_wgmma_kernel"]["gb"] == round(k3_bytes / 1e9, 6)


def test_op_bytes_come_from_the_work_file(tmp_path, capsys):
    """Each traced call of an op takes the op's bytes a call from the work
    file beside the trace (the counted call's: 2 calls of K6 there, so each
    traced call carries half); without the file its bytes are unknown."""
    assert work_path("/d/corpbevt_eval.pt.trace.json") == \
        "/d/corpbevt_eval.work.json"
    assert work_path("/d/x.pt.trace.json.gz") == "/d/x.work.json"
    events = [
        _span("cpu_op", "cobevt::swap_fusion_streaming", 1, 48),
        _launch(10, 1),
        _span("cpu_op", "cobevt::swap_fusion_streaming", 60, 48),
        _launch(70, 2),
        _device("kernel", "void stream_out_wgmma<128>(CUtensorMap)", 100,
                2000, 1),
        _device("kernel", "void stream_out_wgmma<128>(CUtensorMap)", 2200,
                2000, 2),
    ]
    work = {"swap_fusion_streaming": {"calls": 2, "ops": 1.0,
                                      "bytes": 2 * 104146944}}
    root = _write(tmp_path, events, work=work)
    assert main([root, "--bandwidth", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["unknown_ops"] == [] and out["counted_ms"] == 4.0
    assert out["bytes_gb"] == round(2 * 104146944 / 1e9, 6)
    # the work file is no trace
    assert main([root, "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert [r["key"] for r in rows] == [UNSCOPED]
    # without it the op's bytes are unknown
    root = _write(tmp_path / "bare", events)
    assert main([root, "--bandwidth", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["unknown_ops"] == ["cobevt::swap_fusion_streaming"]
    assert out["bytes_gb"] == 0.0 and out["counted_ms"] == 0.0


def test_depth_key():
    assert module_key("a/b/c/d", 2) == "a/b"
    assert module_key("a/b/c/d", 9) == "a/b/c/d"
    assert module_key(UNSCOPED, 2) == UNSCOPED
    assert kernel_name("void (anonymous namespace)::bwd_dq_kernel<64>("
                       "CUtensorMap, Args)") == "bwd_dq_kernel"
    assert kernel_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"


def test_a_cpu_only_trace_exits_2(tmp_path, capsys):
    """A real trace of a small module with the benchmark's scopes, taken on
    the CPU: its scopes are flax paths, and it has no device lane."""
    model = torch.nn.Sequential(
        torch.nn.Linear(8, 8),
        torch.nn.Sequential(torch.nn.ReLU(), torch.nn.Linear(8, 4)))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof, timing.module_scopes(model):
        model(torch.randn(2, 8))
    d = tmp_path / "cpu"
    d.mkdir()
    prof.export_chrome_trace(str(d / "cpu.pt.trace.json"))
    events = load_events(str(d / "cpu.pt.trace.json"))
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"0", "1", "1_0", "1_1"} <= names
    assert main([str(tmp_path), "--json"]) == 2
    assert "no device events" in capsys.readouterr().err
    # no trace at all
    assert main([str(tmp_path / "none")]) == 2
