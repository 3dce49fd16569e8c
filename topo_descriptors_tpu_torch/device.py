"""Device placement for the port.

The JAX package asks "is the default device a TPU?" (``_on_tpu``). Here the
route follows the tensor: a CUDA tensor goes to the hand-written kernels, a
CPU tensor to their plain PyTorch twins, and nothing looks at whether a GPU
happens to be present.
"""

from __future__ import annotations

import numpy as np
import torch

from topo_descriptors_tpu_torch.utils.timing import span

# Bytes the program moved between host memory and a CUDA device, by
# direction: ``as_field`` and ``upload`` count "h2d", ``to_host`` "d2h".
COPIED_BYTES = {"h2d": 0, "d2h": 0}

# Downloads of CUDA tensors into the caching host allocator's pinned blocks
# (``to_host``): how many, their bytes, and how many blocks the pool had to
# allocate for them, so that 1 - pool_grew / pinned is the pool's hit share.
# Kept out of COPIED_BYTES, whose values are summed as bytes moved.
DOWNLOAD_COUNTS = {"pinned": 0, "pinned_bytes": 0, "pool_grew": 0}


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`, a CUDA device with its index
    (the current device where none is given), so that two resolved devices
    compare equal when they are the same card; asking for CUDA where it is
    unavailable raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_field(array, device) -> torch.Tensor:
    """A float32, contiguous tensor of ``array`` on ``device``."""
    dev = resolve_device(device)
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    from_host = array.device.type == "cpu"
    out = array.to(device=dev, dtype=torch.float32).contiguous()
    if from_host and out.is_cuda:
        COPIED_BYTES["h2d"] += out.nbytes
    return out


def upload(array: np.ndarray, device) -> torch.Tensor:
    """A small host table (run groups, ray offsets, count-plane factors) on
    ``device`` without waiting for the device: a blocking copy would
    synchronise the stream, while an asynchronous one from pageable memory
    is staged before it returns, so ``array`` may be dropped at once."""
    out = torch.from_numpy(np.ascontiguousarray(array)).to(device, non_blocking=True)
    if out.is_cuda:
        COPIED_BYTES["h2d"] += out.nbytes
    return out


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array, counting the bytes when it comes off a CUDA
    device.

    A CUDA tensor is downloaded by one blocking copy into a block of torch's
    caching host allocator: pinned memory, so the copy is one DMA at the
    link's rate, with no staging copy and no page faults in a freshly mapped
    buffer. The array is a writeable view of that block and keeps it alive;
    the block goes back to the pool only once every array over it has been
    dropped, and a later download of its size takes it back already pinned.
    So the host memory pinned at once is the downloaded arrays the caller
    still holds, each rounded up by the pool to a power of two. A CPU tensor
    gives ``t.cpu().numpy()``.
    """
    if not t.is_cuda:
        return t.cpu().numpy()
    allocs = _host_allocs()
    out = torch.empty_like(t, device="cpu", pin_memory=True)
    out.copy_(t)
    COPIED_BYTES["d2h"] += t.nbytes
    DOWNLOAD_COUNTS["pinned"] += 1
    DOWNLOAD_COUNTS["pinned_bytes"] += t.nbytes
    DOWNLOAD_COUNTS["pool_grew"] += _host_allocs() - allocs
    return out.numpy()


def _host_allocs() -> int:
    """Blocks the caching host allocator has allocated from the driver."""
    return torch.cuda.host_memory_stats()["num_host_alloc"]


class TableCache:
    """The last ``size`` device tables of a kernel wrapper (run tables, ray
    tables), keyed on the table's contents and the device, so that a
    repeated call uploads nothing. ``builds`` counts the misses: each one
    builds and uploads its tables once."""

    def __init__(self, size: int = 8):
        self.size = size
        self.builds = 0
        self._tables: dict = {}

    def get(self, key, build):
        """The cached value of ``key``, or ``build()``'s, kept in place of
        the oldest entry."""
        with span("prep.table"):
            value = self._tables.get(key)
            if value is None:
                value = build()
                self.builds += 1
                while len(self._tables) >= self.size:
                    self._tables.pop(next(iter(self._tables)))
                self._tables[key] = value
            return value

    def __len__(self) -> int:
        return len(self._tables)

    def clear(self) -> None:
        self._tables.clear()


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; other devices raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")
