"""The card-alone timer that the micro tools and ``chip_smoke.py`` share,
the summary of a ``torch.profiler`` trace that the benchmark and the
trainer share, and the module scopes a written trace carries.

``device_ms(fn, iters)`` is the ms of one call of ``fn`` on the card alone:
the calls are queued behind a sleep kernel, so the host's enqueue time does
not pace them (where a call's host work exceeds its kernel time, CUDA
events around back-to-back calls measure the host).  With ``flush_bytes``,
a write of that many bytes goes before each call, outside the span that
call is timed over, so a call whose inputs fit L2 reads device memory.
"""

from __future__ import annotations

import contextlib

import torch


def device_ms(fn, iters: int, flush_bytes: int = 0) -> float:
    fn()
    torch.cuda.synchronize()
    flush = (torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
             if flush_bytes else None)
    # one span over all calls, or one a call where L2 is flushed between
    spans = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(1 if flush is None else iters)]
    torch.cuda._sleep(20_000_000)
    if flush is None:
        spans[0][0].record()
        for _ in range(iters):
            fn()
        spans[0][1].record()
    else:
        for start, stop in spans:
            flush.zero_()
            start.record()
            fn()
            stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / iters


def device_profile(prof, n: int, ms_per_step: float) -> dict:
    """Sum the kernels and copies that ran on the device in a finished
    ``torch.profiler`` trace of ``n`` steps (or frames): their time, their
    count, and the share of a step of ``ms_per_step`` in which none ran."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue         # operators and annotations repeat kernel time
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3, e.count))
    if not rows:
        raise RuntimeError("torch.profiler recorded no device activity")
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / n
    return {
        "profiled_steps": n,
        "device_ms_per_step": device_ms,
        "device_ops_per_step": sum(r[2] for r in rows) / n,
        "device_idle_share": max(0.0, 1.0 - device_ms / ms_per_step),
        "top_device_ops": [{"name": k[:72], "ms_per_step": ms / n,
                            "count_per_step": c / n}
                           for k, ms, c in rows[:16]],
    }


def scope_name(path: str) -> str:
    """The flax scope name of a module's attribute path, as the weight
    bridge maps it (``utils/weights.py``): ``encoder.layers.0.conv1`` ->
    ``encoder/layers_0/conv1``."""
    from cobevt_tpu_torch.utils.weights import _default_rename
    return "/".join(_default_rename(path.split(".")))


@contextlib.contextmanager
def module_scopes(model):
    """A ``record_function`` scope around every submodule's forward,
    named by :func:`scope_name` of its attribute path, inside the block:
    ``tools/parse_trace.py`` attributes each device event to the innermost
    scope open at its launch, so the module keys of its table are the JAX
    package's scope names."""
    from torch.autograd.profiler import record_function
    open_scopes = []

    def enter(name):
        def hook(module, args):
            scope = record_function(name)
            scope.__enter__()
            open_scopes.append(scope)
        return hook

    def leave(module, args, out):
        open_scopes.pop().__exit__(None, None, None)

    handles = []
    for path, module in model.named_modules():
        if path:
            handles.append(module.register_forward_pre_hook(
                enter(scope_name(path))))
            handles.append(module.register_forward_hook(leave))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        while open_scopes:
            open_scopes.pop().__exit__(None, None, None)
