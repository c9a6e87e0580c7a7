"""Host-side data of the port (counterpart of ``dmlc_core_tpu/data``):
libsvm parsing into :class:`RowBlock` s."""

from .parser import LibSVMParser, create_parser, parse_libsvm  # noqa: F401
from .row_block import RowBlock, concat_blocks  # noqa: F401

__all__ = ["RowBlock", "concat_blocks", "parse_libsvm", "LibSVMParser",
           "create_parser"]
