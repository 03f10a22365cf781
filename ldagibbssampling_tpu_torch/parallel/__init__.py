"""The parallel runtimes: collapsed Gibbs over a mesh of device positions.

Counterpart of ``ldagibbssampling_tpu/parallel/``: document-sharded AD-LDA
(``adlda``), the document × vocabulary grid (``grid``), token sharding
(``tokenshard``) and chains × data (``chaingrid``), over the meshes and the
one reduction of ``multihost`` (``torch.distributed`` across processes).
Each shard's sweep runs the port's kernels (``ops/``) on its position's
device; the reconciliation is a ``psum`` over a named axis.
"""

from ldagibbssampling_tpu_torch.parallel.sharding import CorpusShards, shard_corpus
from ldagibbssampling_tpu_torch.parallel.adlda import ShardedLda, make_sharded_sweep_fn

__all__ = ["CorpusShards", "shard_corpus", "ShardedLda", "make_sharded_sweep_fn"]
