from vq_tpu_torch.utils.run_logger import log_run, load_runs

__all__ = ["log_run", "load_runs"]
