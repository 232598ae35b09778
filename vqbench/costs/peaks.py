"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3, 700 W; dense rates):
the table every roofline of the benchmark is set against.  Copied from
``chip_smoke.py`` (HBM_BYTES_PER_S, PEAK_OPS_PER_S) at commit 6e0cbc3."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {"bf16": 989e12, "f32": 67e12, "f32 add": 33.5e12}


def bound_s(nbytes: float, op_s: float) -> float:
    """The least seconds: the larger of the bytes at the memory rate and the
    operations' seconds at their peak rates."""
    return max(nbytes / HBM_BYTES_PER_S, op_s)
