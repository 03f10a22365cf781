"""Device ops: the deferred sweep and its two kernels (K1 draw, K2 rebuild)."""

from ldagibbssampling_tpu_torch.ops.gibbs import make_sweep_fn

__all__ = ["make_sweep_fn"]
