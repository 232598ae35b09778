"""Spans the benchmark records around calls into the program, from its own
code (the program is not edited): seconds summed by name, each call
synchronised with the card before and after."""

from __future__ import annotations

import functools
import time

import torch


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Timer:
    def __init__(self):
        self.seconds: dict = {}

    def add(self, name: str, dt: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + dt


def timed(fn, timer: Timer, name: str):
    """``fn`` with each call recorded in ``timer`` under ``name``."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync()
        timer.add(name, time.perf_counter() - t0)
        return out
    return call
