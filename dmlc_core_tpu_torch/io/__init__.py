"""The port's I/O layer: URI-addressed streams over local files and the
remote stores (``http(s)://``, ``s3://``, ``gs://``, ``hdfs://``,
``azure://``, :mod:`.remote_filesys`), the recordio codec, the
partition-correct InputSplit engine and the ``fscli`` tool
(``python -m dmlc_core_tpu_torch.io.fscli ls|cat|cp|stat|pack|unpack``).

Counterpart of ``dmlc_core_tpu/io`` (the reference's ``src/io/``).  The
factory :func:`create_input_split` follows the JAX package's rules:

* ``split_type``: ``"text"``/``"line"`` (line records), ``"recordio"``,
  ``"indexed_recordio"`` (an index from ``index_uri`` or ``?index=``),
  ``"stdin"`` (also chosen by the URIs ``stdin://`` and ``-``);
* the URI may be a file, a directory (walked recursively; on an object
  store, a key prefix), a ``;`` list or a ``*``/``?`` glob (local files
  only: no remote filesystem globs, in either package), with ``?k=v`` arguments and a ``#cachefile``
  fragment, which selects the raw-chunk cache (with a
  ``.split{N}.part{K}`` suffix when there is more than one part);
* ``shuffle=True`` over-partitions into ``num_shuffle_parts`` sub-parts
  and visits them in a seeded random order each epoch; it cannot be
  combined with ``#cachefile``;
* otherwise the split prefetches chunks on a thread unless ``threaded``
  is False.
"""

from __future__ import annotations

from typing import Optional

from ..utils.logging import DMLCError, check
from .filesys import (FS_REGISTRY, FileInfo, FileSystem,  # noqa: F401
                      LocalFileSystem, get_filesystem,
                      list_directory_recursive, open_seek_stream_for_read,
                      open_stream)
from .indexed_recordio_split import (IndexedRecordIOSplit,  # noqa: F401
                                     write_recordio_index)
from .input_split import (InputSplit, InputSplitBase,  # noqa: F401
                          LineSplitter, RecordIOSplitter, expand_uris)
from .recordio import (KMAGIC, RecordIOChunkReader,  # noqa: F401
                       RecordIOReader, RecordIOWriter, decode_lrec,
                       encode_lrec)
from .remote_filesys import (AzureFileSystem, GCSFileSystem,  # noqa: F401
                             HttpFileSystem, RangedReadStream, S3FileSystem,
                             WebHDFSFileSystem, sign_v4)
from .single_file_split import SingleFileSplit  # noqa: F401
from .uri import URI, URISpec  # noqa: F401
from .wrappers import (CachedInputSplit, ShuffleInputSplit,  # noqa: F401
                       ThreadedInputSplit)

__all__ = [
    "URI", "URISpec", "FileInfo", "FileSystem", "LocalFileSystem",
    "FS_REGISTRY", "get_filesystem", "open_stream",
    "open_seek_stream_for_read", "list_directory_recursive",
    "KMAGIC", "RecordIOWriter", "RecordIOReader", "RecordIOChunkReader",
    "encode_lrec", "decode_lrec",
    "InputSplit", "InputSplitBase", "LineSplitter", "RecordIOSplitter",
    "ThreadedInputSplit", "CachedInputSplit", "ShuffleInputSplit",
    "IndexedRecordIOSplit", "SingleFileSplit", "write_recordio_index",
    "create_input_split", "expand_uris",
    "RangedReadStream", "HttpFileSystem", "S3FileSystem", "GCSFileSystem",
    "WebHDFSFileSystem", "AzureFileSystem", "sign_v4",
]


def create_input_split(uri: str, part_index: int = 0, num_parts: int = 1,
                       split_type: str = "text", *, threaded: bool = True,
                       shuffle: bool = False, num_shuffle_parts: int = 16,
                       shuffle_seed: int = 0, index_uri: Optional[str] = None,
                       batch_size: int = 256) -> InputSplit:
    """A partitioned record stream over ``uri`` (the reference's
    ``InputSplit::Create``)."""
    spec = URISpec(uri, part_index, num_parts)
    check(num_parts > 0 and 0 <= part_index < num_parts,
          f"bad partition spec {part_index}/{num_parts}")

    if split_type == "stdin" or spec.uri in ("stdin://", "-"):
        return SingleFileSplit(spec.uri)

    if split_type == "indexed_recordio":
        idx = index_uri or spec.args.get("index")
        if idx is None:
            raise DMLCError("indexed_recordio requires index_uri or ?index= arg")
        return IndexedRecordIOSplit(spec.uri, idx, part_index, num_parts,
                                    shuffle=shuffle, seed=shuffle_seed,
                                    batch_size=batch_size)

    def make_base(pi: int, np_: int) -> InputSplitBase:
        if split_type in ("text", "line"):
            return LineSplitter(spec.uri, pi, np_)
        if split_type == "recordio":
            return RecordIOSplitter(spec.uri, pi, np_)
        raise DMLCError(f"unknown InputSplit type {split_type!r}")

    if spec.cache_file is not None and shuffle:
        # refused before any file is opened or cache touched
        raise DMLCError("#cachefile cannot be combined with shuffle "
                        "(the cache wrapper does not repartition; "
                        "reference cached_input_split.h:87)")
    if shuffle:
        base = make_base(part_index * num_shuffle_parts,
                         num_parts * num_shuffle_parts)
        split: InputSplit = ShuffleInputSplit(
            base, part_index, num_parts,
            num_shuffle_parts=num_shuffle_parts, seed=shuffle_seed)
    else:
        split = make_base(part_index, num_parts)

    if spec.cache_file is not None:
        return CachedInputSplit(split, spec.cache_file)
    if threaded:
        return ThreadedInputSplit(split)
    return split
