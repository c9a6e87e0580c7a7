"""Host-side data of the port (counterpart of ``dmlc_core_tpu/data``):
libsvm, libfm and csv parsing into :class:`RowBlock` s, natively or in
python, on the caller's thread or ahead of it on a thread."""

from .parser import (ENGINES, FORMATS, CSVParserParam,  # noqa: F401
                     LibSVMParser, TextParser, ThreadedParser, create_parser,
                     parse_csv, parse_libfm, parse_libsvm)
from .row_block import RowBlock, concat_blocks  # noqa: F401

__all__ = ["RowBlock", "concat_blocks", "parse_libsvm", "parse_libfm",
           "parse_csv", "CSVParserParam", "LibSVMParser", "TextParser",
           "ThreadedParser", "create_parser", "ENGINES", "FORMATS"]
