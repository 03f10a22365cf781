"""Bit-exact reimplementation of ``java.util.Random``.

A copy of ``ldagibbssampling_tpu/utils/javarandom.py`` for the port's oracle.

The reference (``LdaModel.initializeModel`` / ``sampleTopicZ`` in
``src/liuyang/nlp/lda/main/LdaModel.java``) draws every random number through
``Math.random()`` — an *unseeded*, process-global ``java.util.Random``.  Because the
reference is unseeded, bit-level parity is defined against a *seeded* oracle chain
(SURVEY.md §4): this class reproduces Java's 48-bit linear congruential generator so
that the oracle sampler's trajectory is exactly what a seeded Java run would produce.

Algorithm (JDK spec, ``java.util.Random``):
    seed' = (seed * 0x5DEECE66D + 0xB) mod 2**48
    next(bits) = seed' >> (48 - bits)              (signed int semantics)
    nextDouble() = ((next(26) << 27) + next(27)) / 2**53
"""

from __future__ import annotations

_MULT = 0x5DEECE66D
_ADD = 0xB
_MASK = (1 << 48) - 1


class JavaRandom:
    """Drop-in model of ``java.util.Random`` for the seeded-oracle fidelity mode."""

    __slots__ = ("_seed",)

    def __init__(self, seed: int = 0):
        self.set_seed(seed)

    def set_seed(self, seed: int) -> None:
        # Java: this.seed = (seed ^ 0x5DEECE66DL) & ((1L << 48) - 1)
        self._seed = (seed ^ _MULT) & _MASK

    def _next(self, bits: int) -> int:
        self._seed = (self._seed * _MULT + _ADD) & _MASK
        return self._seed >> (48 - bits)

    def next_int(self, bound: int | None = None) -> int:
        if bound is None:
            v = self._next(32)
            # reinterpret as signed 32-bit
            return v - (1 << 32) if v >= (1 << 31) else v
        if bound <= 0:
            raise ValueError("bound must be positive")
        if (bound & -bound) == bound:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) < (1 << 31):
                return val

    def next_double(self) -> float:
        # ((long)next(26) << 27) + next(27)) * 0x1.0p-53
        return ((self._next(26) << 27) + self._next(27)) / float(1 << 53)

    def next_long(self) -> int:
        hi = self._next(32)
        lo = self._next(32)
        v = ((hi << 32) + lo) & ((1 << 64) - 1)
        return v - (1 << 64) if v >= (1 << 63) else v
