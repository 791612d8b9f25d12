"""Drop-in counterpart of the reference ``cobs_index`` module on the
PyTorch port.

The reference ships a pybind11 module named ``cobs_index``
(reference: python/module.cpp:71-395); ``cobs_index.py`` beside this file
re-exports cobs_tpu under its names. This module re-exports
cobs_tpu_torch under the same names and call conventions, so code written
for the reference, its own test suite included
(reference: python/tests/test_cobs_index.py), runs on the port:

    import cobs_index_torch as cobs
    cobs.disable_cache()
    p = cobs.ClassicIndexParameters()
    p.clobber = True
    cobs.classic_construct(input=..., out_file=..., index_params=p)
    cobs.Search(path).search("ACGT...", threshold=0.0, num_results=0)

Construction and `Search` run on `settings.device` (the CUDA card unless
`cobs_tpu_torch.settings.device` says otherwise) and raise without CUDA.
This module imports torch and cobs_tpu_torch only.
"""

from pathlib import Path as _Path

from cobs_tpu_torch import (  # noqa: F401
    ClassicIndexParameters,
    CompactIndexParameters,
    DocumentEntry,
    DocumentList,
    FileType,
    Search,
    SearchResult,
    classic_construct_random,
    disable_cache,
)
from cobs_tpu_torch import (
    classic_construct as _classic_construct,
    classic_construct_list as _classic_construct_list,
    compact_construct as _compact_construct,
    compact_construct_list as _compact_construct_list,
)


def _as_list(input):
    if isinstance(input, DocumentList):
        return input
    return DocumentList(_Path(input))


def classic_construct(input, out_file, index_params=None, tmp_path=None,
                      **kwargs):
    """reference: python/module.cpp classic_construct(input, out_file,
    index_params, tmp_path) — `input` is a file or directory path."""
    return _classic_construct(_as_list(input), out_file, tmp_path=tmp_path,
                              index_params=index_params, **kwargs)


def classic_construct_list(list, out_file, index_params=None,
                           tmp_path=None):
    return _classic_construct_list(list, out_file, index_params=index_params,
                                   tmp_path=tmp_path)


def compact_construct(input, out_file, index_params=None, tmp_path=None,
                      **kwargs):
    return _compact_construct(_as_list(input), out_file, tmp_path=tmp_path,
                              index_params=index_params, **kwargs)


def compact_construct_list(list, out_file, index_params=None,
                           tmp_path=None):
    return _compact_construct_list(list, out_file, index_params=index_params,
                                   tmp_path=tmp_path)
