"""cobs_tpu_torch: the COBS query path on PyTorch and CUDA (NVIDIA Hopper).

The port of `cobs_tpu` (which stays the JAX reference): an index file is
loaded into one int32 matrix on a torch device, query k-mers are hashed
on the device (`ops/csrc/device_hash.cu`), and the fused gather -> AND ->
count runs in a hand-written CUDA kernel (`ops/csrc/gather_count.cu`);
both are built with nvcc at first use. On CPU tensors each kernel's plain
PyTorch version runs instead. Indexes larger than the device budget are
served from a host mmap (`StreamedIndex`, with a host C++ library built
by g++ at first use). This package imports torch and numpy, never jax or
cobs_tpu.
"""

from cobs_tpu_torch.query.engine import DeviceIndex, StreamedIndex
from cobs_tpu_torch.query.search import QueryError, Search, SearchResult
from cobs_tpu_torch.settings import settings

__all__ = ["DeviceIndex", "QueryError", "Search", "SearchResult",
           "StreamedIndex", "settings"]
