"""The card-alone timer that the micro tools and ``chip_smoke.py`` share.

``device_ms(fn, iters)`` is the ms of one call of ``fn`` on the card alone:
the calls are queued behind a sleep kernel, so the host's enqueue time does
not pace them (where a call's host work exceeds its kernel time, CUDA
events around back-to-back calls measure the host).  With ``flush_bytes``,
a write of that many bytes goes before each call, outside the span that
call is timed over, so a call whose inputs fit L2 reads device memory.
"""

from __future__ import annotations

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
