"""Host-side data of the port (counterpart of ``dmlc_core_tpu/data``):
libsvm, libfm and csv parsing into :class:`RowBlock` s, natively or in
python, on the caller's thread or ahead of it on a thread; the growable
:class:`RowBlockContainer`; and the row-block iterators, in memory or
replayed from an on-disk block cache."""

from .iterators import (BasicRowIter, DiskRowIter,  # noqa: F401
                        RowBlockIter, create_row_block_iter)
from .parser import (ENGINES, FORMATS, CSVParserParam,  # noqa: F401
                     LibSVMParser, TextParser, ThreadedParser, create_parser,
                     parse_csv, parse_libfm, parse_libsvm)
from .row_block import (RowBlock, RowBlockContainer,  # noqa: F401
                        concat_blocks)

__all__ = ["RowBlock", "RowBlockContainer", "concat_blocks", "parse_libsvm",
           "parse_libfm", "parse_csv", "CSVParserParam", "LibSVMParser",
           "TextParser", "ThreadedParser", "create_parser", "ENGINES",
           "FORMATS", "RowBlockIter", "BasicRowIter", "DiskRowIter",
           "create_row_block_iter"]
