"""Device time of a few training steps, from ``torch.profiler``: the busy
share of the window and the kernels that fill it; and the card's name and
power limit, which stand beside every time.  ``bench_torch.py`` and
``chip_smoke.py`` read their device-busy figures from here."""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional


def gpu_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def device_rows(prof):
    """(device us, calls, name) of each kernel a profile saw on the card:
    device-side events only, so each kernel is counted once."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.count, e.key))
    return rows


def profile_steps(step: Callable[[int], object], steps: int = 3, log: Callable = print,
                  tag: str = "", gpu: str = "") -> Optional[dict]:
    """Device busy share and device time by kernel over ``steps`` calls of
    ``step(i)``, synchronised before and after.  Logs the window's wall and
    busy ms/step, its idle share, the fifteen kernels of most device time and
    the copy kernels.  Returns ``{"rows", "busy_ms", "wall_ms"}`` (ms per
    step), or None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log(f"[{tag} profile] the profiler saw no device time: not measured")
        return None
    log(f"[{tag} profile] {steps} steps: wall {wall_us / steps / 1e3:.2f} ms/step, device busy "
        f"{busy / steps / 1e3:.2f} ms/step ({100 * busy / wall_us:.1f}%), "
        f"idle {100 * (1 - busy / wall_us):.1f}% | {gpu}")
    for us, count, key in sorted(rows, reverse=True)[:15]:
        log(f"[{tag} profile]   {us / steps / 1e3:8.3f} ms/step  {count // steps:4d} calls/step  "
            f"{key[:90]}")
    copies = [(us, count) for us, count, key in rows if "direct_copy_kernel" in key]
    log(f"[{tag} profile] copy kernels (direct_copy_kernel_cuda): "
        f"{sum(c for _, c in copies) // steps} calls/step, "
        f"{sum(u for u, _ in copies) / steps / 1e3:.3f} ms/step")
    return {"rows": rows, "busy_ms": busy / steps / 1e3, "wall_ms": wall_us / steps / 1e3}
