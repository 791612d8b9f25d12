"""Global runtime settings of the PyTorch port.

A subset of `cobs_tpu.settings` (reference: cobs/settings.hpp:16-23):
the device that holds the index, the largest index file loaded onto it,
and where query hashing runs. The TPU package's dispatch knobs
(mega-dispatch, hash-ahead depth, dispatch groups, tier fetch) worked
around its slow host link and have no counterpart here.
"""

import dataclasses
import os


@dataclasses.dataclass
class Settings:
    #! torch device that holds the index matrix and runs the kernels
    device: str = "cuda"
    #! index files larger than this are refused: the streamed
    #! (host-mmap) backend that serves them is not ported yet
    max_device_index_bytes: int = int(os.environ.get(
        "COBS_TPU_DEVICE_INDEX_BYTES", 64 << 30))
    #! where query hashing runs: "auto"/"device" = on the index's device
    #! (upload the raw query bytes; the device_hash kernel computes the
    #! row ids before the gather-and-count kernel), "host" = the numpy
    #! pipeline (create_hashes + row_indices, then upload the row ids)
    device_hash: str = dataclasses.field(default_factory=lambda: os.environ
                                         .get("COBS_TPU_DEVICE_HASH",
                                              "auto"))


settings = Settings()
