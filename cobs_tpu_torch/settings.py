"""Global runtime settings of the PyTorch port.

A subset of `cobs_tpu.settings` (reference: cobs/settings.hpp:16-23):
the device that holds the index and the largest index file loaded onto
it. The TPU package's dispatch knobs (mega-dispatch, hash-ahead depth,
dispatch groups, tier fetch, device hashing) have no counterpart here.
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


settings = Settings()
