"""A torch.profiler window over a steady stretch of batches, reduced to the
numbers the per-layer metrics read.

The arithmetic is that of ``chip_smoke.py::profile_fn`` at commit 6e0cbc3
(device activity from the profiler's CUDA events, kernels counted without
Memcpy/Memset, idle share = 1 − device busy / wall), with busy time taken
as the union of the device intervals, so that overlapping work counts once.
The trace stays in memory; nothing is written to disk.
"""

from __future__ import annotations

import time

import numpy as np
import torch

TOP = 10  # entries of each list of the breakdown
GAPS_NAMED = 512  # longest idle gaps attributed to a host operation


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted (start, end) rows → their union as disjoint intervals."""
    if len(iv) == 0:
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def reduce(events, window_s: float, batches: int) -> dict:
    """Profiler events of ``batches`` batches over ``window_s`` host seconds →
    busy_s (union of device intervals), kernels (device kernels, without
    copies and fills), device_ops [[name, s]], idle_gaps [[host op, s]]."""
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    if not dev:
        return {"busy_s": 0.0, "window_s": window_s, "batches": batches, "kernels": 0,
                "device_ops": [], "idle_gaps": []}
    iv = np.asarray([(s, e) for s, e, _ in dev], dtype=np.float64)
    merged = _merge(iv)
    busy_us = float(np.sum(merged[:, 1] - merged[:, 0]))
    per_op: dict = {}
    for s, e, name in dev:
        per_op[name] = per_op.get(name, 0.0) + (e - s) * 1e-6
    kernels = sum(not name.startswith(("Memcpy", "Memset")) for _, _, name in dev)
    gaps = np.stack([merged[:-1, 1], merged[1:, 0]], axis=1) if len(merged) > 1 \
        else np.zeros((0, 2))
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:GAPS_NAMED]
    by_host: dict = {}
    if len(host):
        hs = np.asarray([h[0] for h in host], dtype=np.float64)
        he = np.asarray([h[1] for h in host], dtype=np.float64)
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = host[inside[np.argmin(he[inside] - hs[inside])]][2] if len(inside) \
                else "host, no op recorded"
            by_host[name] = by_host.get(name, 0.0) + (g1 - g0) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": window_s, "batches": batches,
            "kernels": kernels,
            "device_ops": sorted(([k, v] for k, v in per_op.items()), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:TOP]}


def profile(run_batch, batches: int) -> dict:
    """torch.profiler over ``batches`` calls of ``run_batch(i)``, after the
    card is idle → ``reduce``'s numbers."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(batches):
            run_batch(i)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), window_s, batches)
