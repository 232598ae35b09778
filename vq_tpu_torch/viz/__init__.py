from vq_tpu_torch.viz.plot import plot

__all__ = ["plot"]
