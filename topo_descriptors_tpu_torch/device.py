"""Device placement for the port.

The JAX package asks "is the default device a TPU?" (``_on_tpu``). Here the
route follows the tensor: a CUDA tensor goes to the hand-written kernels, a
CPU tensor to their plain PyTorch twins, and nothing looks at whether a GPU
happens to be present.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; asking for CUDA where it is
    unavailable raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def as_field(array, device) -> torch.Tensor:
    """A float32, contiguous tensor of ``array`` on ``device``."""
    dev = resolve_device(device)
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    return array.to(device=dev, dtype=torch.float32).contiguous()


def upload(array: np.ndarray, device) -> torch.Tensor:
    """A small host table (run groups, ray offsets, count-plane factors) on
    ``device`` without waiting for the device: a blocking copy would
    synchronise the stream, while an asynchronous one from pageable memory
    is staged before it returns, so ``array`` may be dropped at once."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(device, non_blocking=True)


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")
