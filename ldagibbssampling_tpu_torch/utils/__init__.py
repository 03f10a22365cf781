"""Host utilities of the port (pure Python, no torch)."""

from ldagibbssampling_tpu_torch.utils.javarandom import JavaRandom

__all__ = ["JavaRandom"]
