"""One run of one benchmark cell: set-up, a closed-loop window, the check
that decides ``correct``, the metrics, one JSON line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name under the root (the checkout):

    BENCHMARK.json                    cells, metrics, configurations
    <config file>                     sizes, system, reference, limits
    vqbench/traffic/<mix>.json        the generator's parameters
    vqbench/corpora/<maker>.py        make(n, d, nq, seed, device, **params)
    vqbench/systems/<name>.py         build / search / state / counters / work
    vqbench/reference/<name>.py       judge / control (plain torch)
    vqbench/e2e_metrics/<name>.py     read(run) → number
    vqbench/layer_metrics/<name>.py   read(ctx) → number, or None
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path

import torch

from vqbench import generator, spans, tracing
from vqbench.reference import common

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "vq_tpu")
WARM_BATCHES = 3  # batches of the cell's shape sent in set-up
TRACE_LEAD_S = 2.0  # a traced run's answered lead before the profiler
TRACE_TARGET_S = 0.5  # host seconds of batches the profiler window aims for
TRACE_BATCHES = (3, 100)
COUNTED_BATCHES = 64  # batches whose program counters are read


class NoCard(RuntimeError):
    pass


def parse(argv):
    p = argparse.ArgumentParser(prog="vqbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load(root: Path, kind: str, name: str):
    """The module ``vqbench/<kind>/<name>.py`` under ``root``."""
    path = root / "vqbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no {kind} named {name!r}")
    spec = importlib.util.spec_from_file_location(f"vqbench_{kind}_{name}".replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str):
    """→ (BENCHMARK.json, the cell, its configuration file, its mix)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "vqbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, mix


def cell_metrics(bench: dict, cell: str):
    """→ (the end-to-end metrics the cell reports, its per-layer metrics)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def make_data(root: Path, cfg: dict, seed: int, device):
    """The deployment's corpus and query pool, made on ``device`` from
    ``seed`` (the run's ``--seed``, which also draws the traffic)."""
    corpus = cfg["corpus"]
    return load(root, "corpora", corpus["maker"]).make(
        cfg["n"], cfg["d"], cfg["num_queries"], seed, device, **corpus.get("params", {}))


def forbidden_modules():
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole (``vq_tpu_torch`` is not ``vq_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Traffic:
    """The mix's stream of pool rows on the card, batch ``j`` gathered from
    the pool when it is sent (the stream starts over if a window outruns
    it)."""

    def __init__(self, pool, mix: dict, seed: int):
        self.pool, self.b = pool, mix["batch"]
        self.rows = generator.stream(pool.shape[0], mix, seed)
        self.rows_dev = torch.as_tensor(self.rows, device=pool.device)
        self.count = len(self.rows) // self.b

    def __call__(self, j: int):
        """→ (pool rows (numpy), the queries on the card)."""
        i0 = (j % self.count) * self.b
        return self.rows[i0:i0 + self.b], self.pool.index_select(0, self.rows_dev[i0:i0 + self.b])


def window(system, index, traffic: Traffic, k: int, seconds: float, start: int = 0):
    """Back-to-back batches until ``seconds`` have passed → (answers
    [(pool rows, ids, scores)], the window's seconds, to the last answer)."""
    answers = []
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        while True:
            rows, qb = traffic(start + len(answers))
            ids, scores = system.search(index, qb, k)
            answers.append((rows, ids, scores))
            te = time.perf_counter()
            if te - t0 >= seconds:
                return answers, te - t0
    finally:
        gc.enable()


def run(argv, root: Path = ROOT, device=None, t_start=None, out=sys.stdout) -> int:
    """One run.  ``device`` None looks for the card (and fails without
    the chips the cell asks for); the CPU tests pass ``"cpu"``."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench, cell, cfg, mix = load_cell(root, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
                         f"torch.cuda.is_available() = {torch.cuda.is_available()}")
        device = "cuda:0"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    k = mix["k"]

    # ------------------------------------------------------------ set-up
    x, pool = make_data(root, cfg, args.seed, dev)
    system = load(root, "systems", cfg["system"])
    timer = spans.Timer() if args.trace else None
    spans.sync()
    t_b = time.perf_counter()
    index = system.build(x, cfg, mix, timer)
    spans.sync()
    build_s = time.perf_counter() - t_b
    traffic = Traffic(pool, mix, args.seed)
    for j in range(WARM_BATCHES):
        system.search(index, traffic(j)[1], k)
    spans.sync()
    setup_s = time.perf_counter() - t_start
    log(f"[vqbench] {cell['name']} seed {args.seed}: set-up {setup_s:.3f} s (build "
        f"{build_s:.3f} s)")

    # ------------------------------------------------------------ window
    # a traced run answers (and has judged) a lead of TRACE_LEAD_S, then
    # profiles a short stretch: its end-to-end numbers are not reported
    seconds = min(args.seconds, TRACE_LEAD_S) if args.trace else args.seconds
    answers, window_s = window(system, index, traffic, k, seconds, WARM_BATCHES)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"[vqbench] window {window_s:.3f} s, {len(answers)} batches")

    e2e, layer = cell_metrics(bench, cell["name"])
    metrics = {}
    breakdown = tr = None
    if args.trace:
        nb = int(min(max(math.ceil(TRACE_TARGET_S / (window_s / len(answers))), TRACE_BATCHES[0]),
                     TRACE_BATCHES[1]))
        qb = [traffic(WARM_BATCHES + len(answers) + i)[1] for i in range(nb)]
        tr = tracing.profile(lambda i: system.search(index, qb[i], k), nb)
        count = system.work(index, x, cfg, mix)
        work = [count(b) for b in qb]
        counters = []
        for b in qb[:COUNTED_BATCHES]:
            system.search(index, b, k)
            counters.append(system.counters(index))
        ctx = types.SimpleNamespace(cfg=cfg, mix=mix, cell=cell, trace=tr, work=work,
                                    counters=counters, spans=timer.seconds, rows=cfg["n"])
        for m in layer:
            v = load(root, "layer_metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        del qb

    # ------------------------------------------------------------ check
    state = system.state(index)
    del index
    if cuda:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    numbers = load(root, "reference", cfg["reference"]).judge(x, pool, state, answers, cfg, mix,
                                                              args.seed)
    del state
    log(f"[vqbench] reference check {time.perf_counter() - t_c:.3f} s")
    limits = cfg["limits"]
    checks = {name: {"value": float(numbers[name]), "limit": float(limits[name])}
              for name in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if not args.trace:
        r = types.SimpleNamespace(queries=sum(len(a[0]) for a in answers), window_s=window_s,
                                  answers=answers, pool=pool, corpus=x, mix=mix,
                                  build_s=build_s, setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": float(load(root, "e2e_metrics", m["name"]).read(r)),
                                  "unit": m["unit"]}
    ids = common.stack_answers(answers)[1]
    failed = int(((ids < 0) | (ids >= cfg["n"])).any(axis=1).sum())

    found = forbidden_modules()
    if found:
        log(f"[vqbench] refused: modules of {found} were loaded in this process")
        return 3
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if tr is not None:
        info.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    result = {"correct": correct, "attempted": int(ids.shape[0]), "failed": failed,
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None, t_start=None) -> int:
    try:
        return run(sys.argv[1:] if argv is None else argv, t_start=t_start)
    except NoCard as e:
        log(f"[vqbench] {e}")
        return 2
