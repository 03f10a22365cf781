"""Device values shared by the kernel wrappers and the captured sweep.

α, β, V·β and K·α as the reference forms them (``sweep_scalars``), a sweep
seed as the int64 word the kernels take (``seed_word``), and host arrays
moved to a card without a host wait (``device_values``).
"""

from __future__ import annotations

import numpy as np
import torch


def sweep_scalars(alpha: float, beta: float, vocab_size: int,
                  num_topics: int) -> np.ndarray:
    """α, β, V·β and K·α as float32, formed as the reference forms them: α
    and β rounded to float32, the products of float32 values."""
    a, b = np.float32(alpha), np.float32(beta)
    return np.array([a, b, np.float32(vocab_size) * b, np.float32(num_topics) * a],
                    np.float32)


def seed_word(seed: int) -> int:
    """``seed``'s low 64 bits as a signed int64 (the bits the kernels take)."""
    s = int(seed) & (2**64 - 1)
    return s - 2**64 if s >= 2**63 else s


def staged(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """``values`` as a host tensor, pinned when it is bound for a card."""
    host = torch.from_numpy(np.ascontiguousarray(values))
    return host.pin_memory() if device.type == "cuda" else host


def device_values(values: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``; to a card through pinned
    memory and a copy on the current stream, so the host does not wait
    (PyTorch keeps the pinned block until the copy has run)."""
    dev = torch.device(device)
    return staged(values, dev).to(dev, non_blocking=True)
