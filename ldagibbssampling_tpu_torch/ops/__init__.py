"""Device ops: the deferred sweep and its two kernels (K1 draw, K2 rebuild)."""

from ldagibbssampling_tpu_torch.ops.gibbs import gibbs_sweep, make_sweep_fn

__all__ = ["gibbs_sweep", "make_sweep_fn"]
