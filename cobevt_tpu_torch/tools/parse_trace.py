"""Aggregate a torch.profiler trace into a per-module device-time table.

Counterpart of ``cobevt_tpu/tools/parse_trace.py``, with its flags and its
JSON keys.  Capture a trace with ``tools/benchmark.py --profile_dir DIR``,
then attribute device time to model modules:

    python -m cobevt_tpu_torch.tools.parse_trace DIR [--depth 3] [--top 30]
    python -m cobevt_tpu_torch.tools.parse_trace DIR --by op   # kernel name
    python -m cobevt_tpu_torch.tools.parse_trace DIR --bandwidth [--json]

Reads the newest ``*.pt.trace.json[.gz]`` (the Chrome trace
``torch.profiler`` exports) under DIR.  Device events are those of ``cat``
``kernel``, ``gpu_memcpy`` and ``gpu_memset``; each is attributed to its
host side through ``args.correlation``: the launch event of the same
correlation (``cuda_runtime`` / ``cuda_driver``; where the trace has none,
the operator of the kernel's ``External id``), then the innermost
``user_annotation`` scope open on that thread at the launch.  The benchmark
names a scope after each module's flax path (``tools/timing.py:
module_scopes``), so module keys are the first ``--depth`` segments of that
path, the JAX table's keys; a launch outside every scope is ``<unscoped>``.
``--by op`` keys rows by kernel name (a row's ``ops`` are the ``cobevt::``
kernel ops that launched it: K4 and K6 launch K1's attention kernel too).
torch's own annotations (a ``#`` in the name: ``Optimizer.step#AdamW.step``,
``ProfilerStep#N``) are no module scopes.

``--bandwidth`` sums bytes over the device events whose bytes are known:
a copy's or memset's from the trace, a hand kernel's from its op's work
formula (``utils/flops.py``), shared out over the op call's kernels by
their time.  The formula's bytes come from the file the benchmark writes
beside the trace (:func:`work_path`): the counted call's work by kernel op,
of which each traced call of an op takes the op's bytes per call.  A trace
may record no dims of a tensor list, and K2's, K4's and K6's weights come
as one, so the trace alone cannot give them.  The profiled frames or steps
repeat the counted one, so an op's total is exact; where its calls differ
in shape, one call's share is their mean.  Without the file, and for other
kernels, bytes are null; ``achieved_gbs`` is the known bytes over the time
of the events that carry them.

A trace with no device events (a CPU-only profile) exits 2: unlike the JAX
tool, this one never falls back to host lanes.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNSCOPED = "<unscoped>"


def find_trace_files(root: str):
    pats = [os.path.join(root, "**", "*.pt.trace.json.gz"),
            os.path.join(root, "**", "*.pt.trace.json")]
    files = []
    for p in pats:
        files.extend(glob.glob(p, recursive=True))
    return sorted(files, key=os.path.getmtime)


def work_path(trace_path: str) -> str:
    """The work file beside a trace: ``<name>.pt.trace.json[.gz]`` ->
    ``<name>.work.json``."""
    base = trace_path[:-3] if trace_path.endswith(".gz") else trace_path
    return base[:-len(".pt.trace.json")] + ".work.json"


def load_work(trace_path: str) -> dict:
    """{``cobevt::<op>``: bytes a call} from the trace's work file, or {}
    where it has none."""
    path = work_path(trace_path)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        kernels = json.load(f)["kernels"]
    return {f"cobevt::{k}": v["bytes"] / v["calls"]
            for k, v in kernels.items() if v["calls"]}


def load_events(path: str):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def device_events(events):
    """The complete events that ran on the device."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def kernel_name(name: str) -> str:
    """A kernel's name without ``void``, namespaces, template and
    arguments: ``void (anonymous namespace)::conv3x3_wgmma_kernel<...>(...)``
    -> ``conv3x3_wgmma_kernel``."""
    n = name[5:] if name.startswith("void ") else name
    n = n.replace("(anonymous namespace)::", "")
    n = n.split("<")[0].split("(")[0].split("::")[-1].strip()
    return n or name


class _Intervals:
    """Nested [ts, ts + dur] events of one thread, for the innermost one
    open at a time."""

    def __init__(self, evs):
        self.evs = sorted(evs, key=lambda e: float(e["ts"]))
        self.starts = [float(e["ts"]) for e in self.evs]

    def innermost(self, ts: float):
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0:
            e = self.evs[i]
            if float(e["ts"]) + float(e.get("dur", 0.0)) >= ts:
                return e
            i -= 1
        return None


class Attribution:
    """Each device event's host anchor, module scope and kernel op."""

    def __init__(self, events):
        self.launch = {}
        self.by_external = {}
        scopes = collections.defaultdict(list)
        kernel_ops = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            args = e.get("args") or {}
            cat = e.get("cat")
            if cat in _LAUNCH_CATS and "correlation" in args:
                self.launch[args["correlation"]] = e
            elif (cat == "user_annotation"
                  and "#" not in str(e.get("name", ""))):
                # torch's own annotations (Optimizer.step#AdamW.step,
                # ProfilerStep#N) are no module scopes
                scopes[(e.get("pid"), e.get("tid"))].append(e)
            elif cat == "cpu_op":
                if "External id" in args:
                    self.by_external[args["External id"]] = e
                if str(e.get("name", "")).startswith("cobevt::"):
                    kernel_ops[(e.get("pid"), e.get("tid"))].append(e)
        self.scopes = {k: _Intervals(v) for k, v in scopes.items()}
        self.kernel_ops = {k: _Intervals(v) for k, v in kernel_ops.items()}

    def anchor(self, ev):
        """The host event that launched ``ev``, or None."""
        args = ev.get("args") or {}
        host = self.launch.get(args.get("correlation"))
        if host is None:
            host = self.by_external.get(args.get("External id"))
        return host

    def _innermost(self, table, ev):
        host = self.anchor(ev)
        if host is None:
            return None
        found = table.get((host.get("pid"), host.get("tid")))
        return found.innermost(float(host["ts"])) if found else None

    def scope(self, ev) -> str:
        s = self._innermost(self.scopes, ev)
        return s["name"] if s is not None else UNSCOPED

    def kernel_op(self, ev):
        """The ``cobevt::`` op event whose call launched ``ev``, or None."""
        return self._innermost(self.kernel_ops, ev)


def module_key(scope: str, depth: int) -> str:
    if scope == UNSCOPED:
        return scope
    return "/".join(scope.split("/")[:depth])


def bandwidth_report(events, by="category", work=None):
    """Measured roofline position from the trace: bytes of the device
    events that carry them (copies, memsets, hand kernels: ``work`` gives
    each ``cobevt::`` op's bytes a call, :func:`load_work`) over their
    summed time.  ``by="op"`` keys rows by kernel name instead of category
    (``cobevt::<op>`` for a hand kernel, the copy's name, ``other
    kernels``)."""
    work = work or {}
    attr = Attribution(events)
    devs = device_events(events)
    calls = collections.defaultdict(list)      # op call -> its kernels
    for e in devs:
        if e.get("cat") == "kernel":
            op = attr.kernel_op(e)
            if op is not None:
                calls[id(op)].append((e, op))
    share, unknown = {}, set()
    for kernels in calls.values():
        b = work.get(kernels[0][1]["name"])
        if b is None:
            unknown.add(kernels[0][1]["name"])
        total = sum(float(e.get("dur", 0.0)) for e, _ in kernels) or 1.0
        for e, _ in kernels:
            share[id(e)] = (None if b is None
                            else b * float(e.get("dur", 0.0)) / total)
    total_us = counted_us = 0.0
    total_bytes = 0.0
    rows = collections.defaultdict(lambda: [0.0, 0.0, False])
    for e in devs:
        dur = float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if e.get("cat") == "kernel":
            b = share.get(id(e))
            op = attr.kernel_op(e)
            cat = op["name"] if op is not None else "other kernels"
        else:
            b = args.get("bytes")
            b = float(b) if b is not None else None
            cat = e.get("name", e.get("cat"))
        key = kernel_name(e.get("name", "")) if by == "op" else cat
        total_us += dur
        rows[key][0] += dur
        if b is not None:
            counted_us += dur
            total_bytes += b
            rows[key][1] += b
            rows[key][2] = True
    cats = [
        {"category": c, "ms": round(d / 1e3, 3),
         "gb": round(bb / 1e9, 6) if known else None,
         "gbs": round(bb / 1e9 / (d / 1e6), 1) if known and d else None}
        for c, (d, bb, known) in sorted(rows.items(),
                                        key=lambda kv: -kv[1][0])
    ]
    return {
        "leaf_device_ms": round(total_us / 1e3, 3),
        "counted_ms": round(counted_us / 1e3, 3),
        "bytes_gb": round(total_bytes / 1e9, 6),
        "achieved_gbs": round(total_bytes / 1e9 / (counted_us / 1e6), 1)
        if counted_us else None,
        "by_category": cats,
        # hand kernel ops whose calls carry no bytes
        "unknown_ops": sorted(unknown),
    }


def table(events, depth: int, by: str):
    """(device total us, {key: us}, {key: the kernel ops that launched
    it})."""
    attr = Attribution(events)
    total_us = 0.0
    rows = collections.defaultdict(float)
    launched_by = collections.defaultdict(set)
    for e in device_events(events):
        dur = float(e.get("dur", 0.0))
        if dur <= 0:
            continue
        total_us += dur
        if by == "op":
            key = kernel_name(e.get("name", ""))
            if e.get("cat") == "kernel":
                op = attr.kernel_op(e)
                if op is not None:
                    launched_by[key].add(op["name"])
        else:
            key = module_key(attr.scope(e), depth)
        rows[key] += dur
    return total_us, rows, launched_by


def main(argv=None):
    ap = argparse.ArgumentParser("cobevt_tpu_torch trace table")
    ap.add_argument("trace_dir")
    ap.add_argument("--depth", type=int, default=3,
                    help="scope segments to keep per module key")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--by", choices=["module", "op"], default="module")
    ap.add_argument("--bandwidth", action="store_true",
                    help="report measured bytes/s of the device events "
                         "whose bytes are known (roofline position)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full table as one JSON line")
    opt = ap.parse_args(argv)

    files = find_trace_files(opt.trace_dir)
    if not files:
        print(f"no trace files under {opt.trace_dir}", file=sys.stderr)
        return 2
    events = load_events(files[-1])
    if not device_events(events):
        print(f"parse_trace: {files[-1]} has no device events (kernel, "
              f"gpu_memcpy, gpu_memset): a CPU-only trace has no device "
              f"time to attribute", file=sys.stderr)
        return 2

    if opt.bandwidth:
        rep = bandwidth_report(events, by=opt.by if opt.by == "op"
                               else "category", work=load_work(files[-1]))
        rep["trace"] = files[-1]
        if opt.json:
            print(json.dumps(rep))
        else:
            print(f"leaf device time {rep['leaf_device_ms']:.1f} ms, "
                  f"{rep['bytes_gb']:.2f} GB known over "
                  f"{rep['counted_ms']:.1f} ms -> {rep['achieved_gbs']} GB/s")
            for c in rep["by_category"][:opt.top]:
                gb = "      -" if c["gb"] is None else f"{c['gb']:8.2f}"
                print(f"  {c['ms']:9.2f} ms {gb} GB "
                      f"{(c['gbs'] or 0):7.1f} GB/s  {c['category']}")
        return 0

    total_us, rows, launched_by = table(events, opt.depth, opt.by)
    ranked = sorted(rows.items(), key=lambda kv: -kv[1])
    if opt.json:
        out_rows = []
        for k, v in ranked[:opt.top]:
            row = {"key": k, "ms": round(v / 1e3, 3),
                   "pct": round(100 * v / total_us, 2)}
            if opt.by == "op":
                row["ops"] = sorted(launched_by.get(k, ()))
            out_rows.append(row)
        print(json.dumps({"trace": files[-1],
                          "device_total_ms": round(total_us / 1e3, 3),
                          "rows": out_rows}))
        return 0
    print(f"device total: {total_us / 1e3:.2f} ms "
          f"({len(files)} trace file(s); using {os.path.basename(files[-1])})")
    for k, v in ranked[:opt.top]:
        extra = (f"  [{', '.join(sorted(launched_by[k]))}]"
                 if launched_by.get(k) else "")
        print(f"{v / 1e3:9.3f} ms  {100 * v / total_us:5.1f}%  {k}{extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
