"""cobs_tpu_torch: COBS index construction and queries on PyTorch and CUDA
(NVIDIA Hopper).

The port of `cobs_tpu` (which stays the JAX reference). Construction
reads and hashes documents on the host with a native C++ library (built by
g++ at first use) and sets the Bloom bits of each batch on the device with
a hand-written CUDA kernel (`ops/csrc/construct_scatter.cu`), writing the
same `.cobs_classic` and `.cobs_compact` files as `cobs_tpu`. A query
loads an index file into one int32 matrix on a torch device, hashes its
k-mers on the device (`ops/csrc/device_hash.cu`), and runs the fused
gather -> AND -> count in another kernel (`ops/csrc/gather_count.cu`);
the kernels are built with nvcc at first use. On CPU tensors each
kernel's plain PyTorch version runs instead. Indexes larger than the
device budget are served from a host mmap (`StreamedIndex`). This package
imports torch and numpy, never jax or cobs_tpu.
"""

from cobs_tpu_torch.construct.classic import (
    classic_combine,
    classic_construct,
    classic_construct_from_documents,
    classic_construct_list,
    classic_construct_random,
)
from cobs_tpu_torch.construct.compact import (
    compact_combine_into_compact,
    compact_construct,
    compact_construct_list,
    compact_repack,
)
from cobs_tpu_torch.construct.params import (
    ClassicIndexParameters,
    CompactIndexParameters,
)
from cobs_tpu_torch.ingest.document_list import (
    DocumentEntry,
    DocumentList,
    FileType,
)
from cobs_tpu_torch.query.engine import DeviceIndex, StreamedIndex
from cobs_tpu_torch.query.search import QueryError, Search, SearchResult
from cobs_tpu_torch.settings import disable_cache, settings

__all__ = [
    "ClassicIndexParameters",
    "CompactIndexParameters",
    "DeviceIndex",
    "DocumentEntry",
    "DocumentList",
    "FileType",
    "QueryError",
    "Search",
    "SearchResult",
    "StreamedIndex",
    "classic_combine",
    "classic_construct",
    "classic_construct_from_documents",
    "classic_construct_list",
    "classic_construct_random",
    "compact_combine_into_compact",
    "compact_construct",
    "compact_construct_list",
    "compact_repack",
    "disable_cache",
    "settings",
]
