"""Global runtime settings of the PyTorch port.

A subset of `cobs_tpu.settings` (reference: cobs/settings.hpp:16-23):
the device that holds the index and runs construction's bit scatter, the
host worker threads, whether document caches are written, when an index
is streamed from host mmap instead of held on the device, where the
streamed backend scores, and where query hashing runs. The TPU package's
dispatch knobs (mega-dispatch, hash-ahead depth, dispatch groups, tier
fetch) worked around its slow host link and have no counterpart here.
"""

import dataclasses
import os


@dataclasses.dataclass
class Settings:
    #! torch device that holds the index matrix and runs the kernels
    device: str = "cuda"
    #! host worker threads (ingest, hashing and the host scatter of
    #! construction; the streamed backend's row gather and host scorer)
    threads: int = os.cpu_count() or 1
    #! disable reading and writing of `.cobs_cache` document caches
    disable_cache: bool = False
    #! load every index file onto the device, whatever its size (the
    #! reference's --load-complete)
    load_complete_index: bool = False
    #! index files larger than this are served by the streamed backend
    #! (StreamedIndex: the payload stays in a host mmap and each batch
    #! reads only the rows it touches) instead of held on the device
    max_device_index_bytes: int = int(os.environ.get(
        "COBS_TPU_DEVICE_INDEX_BYTES", 64 << 30))
    #! where the streamed backend scores a batch: "device" = gather the
    #! batch's unique rows on the host, upload them and run the
    #! gather-and-count kernel; "host" = the native host scorer
    #! (native.score_batch_host) off the mmap, with no device work;
    #! "auto" = "device" when the index's device is CUDA, else "host"
    streamed_host_score: str = dataclasses.field(
        default_factory=lambda: os.environ.get("COBS_TPU_STREAMED_SCORE",
                                               "auto"))
    #! where query hashing runs: "auto"/"device" = on the index's device
    #! (upload the raw query bytes; the device_hash kernel computes the
    #! row ids before the gather-and-count kernel), "host" = the numpy
    #! pipeline (create_hashes + row_indices, then upload the row ids).
    #! A streamed index that scores on the host, or whose row ids
    #! exceed int32, always hashes on the host.
    device_hash: str = dataclasses.field(default_factory=lambda: os.environ
                                         .get("COBS_TPU_DEVICE_HASH",
                                              "auto"))


settings = Settings()


def disable_cache(disable: bool = True) -> None:
    """Disable reading and writing of document cache files
    (`cobs_index.disable_cache()`, reference: python/module.cpp:389-394)."""
    settings.disable_cache = disable
