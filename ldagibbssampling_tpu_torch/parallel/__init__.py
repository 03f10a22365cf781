"""The parallel runtimes: collapsed Gibbs over a mesh of device positions.

Counterpart of ``ldagibbssampling_tpu/parallel/``: document-sharded AD-LDA
(``adlda``), the document × vocabulary grid (``grid``), token sharding
(``tokenshard``) and chains × data (``chaingrid``), over the meshes and the
one reduction of ``multihost`` (``torch.distributed`` across processes).
Each shard's sweep runs the port's kernels (``ops/``) on its position's
device; the reconciliation is a ``psum`` over a named axis.
"""
