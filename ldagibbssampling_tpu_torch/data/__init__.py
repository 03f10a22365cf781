"""Data assets: stand-in mini-corpus generator + reference parameter file.

The reference bundles a small plain-text example corpus under
``data/LdaOriginalDocs/`` and a tab-separated parameter file (SURVEY.md §2.1
#8-#9); neither ships with the repository, so :mod:`minicorpus` generates a
deterministic stand-in with the same statistical shape.
"""

from ldagibbssampling_tpu_torch.data.minicorpus import generate_minicorpus, write_minicorpus

__all__ = ["generate_minicorpus", "write_minicorpus"]
