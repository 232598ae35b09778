"""The control of a cell's check: the plain reference put in the program's
place one precision lower than the configuration states (TF32 for its
f32 stages, float8 e4m3 for its bf16 scan), judged by the same check as a
run.  Its numbers are the upper readings the limits are set below; a
sound run's are the lower ones.  The benchmark's own runs never run it.

    python3 vqbench/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed on standard output: the seed, the numbers, each
beside the cell's limit, and whether they would pass.  It answers the
batches a run judges: a pass over the pool for a check that judges every
answer, ``judge_batches`` batches where the check samples."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout, not this directory

import torch  # noqa: E402

from vqbench import generator, harness  # noqa: E402


def control_numbers(root, workload: str, seed: int, device) -> dict:
    """One seed: the control's state and answers, judged → {number: value}."""
    _, _, cfg, mix = harness.load_cell(root, workload)
    x, pool = harness.make_data(root, cfg, seed, device)
    count = mix.get("judge_batches") or -(-cfg["num_queries"] // mix["batch"])
    batches = generator.batches(cfg["num_queries"], mix, seed, count)
    ref = harness.load(root, "reference", cfg["reference"])
    state, answers = ref.control(x, pool, cfg, mix, batches)
    return ref.judge(x, pool, state, answers, cfg, mix, seed)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vqbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    root = harness.ROOT
    limits = harness.load_cell(root, args.workload)[2]["limits"]
    for s in args.seeds.split(","):
        t = time.perf_counter()
        nums = control_numbers(root, args.workload, int(s), torch.device("cuda:0"))
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "seconds": time.perf_counter() - t,
                          "numbers": nums, "limits": limits,
                          "passes": all(nums[n] <= lim for n, lim in limits.items())}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
