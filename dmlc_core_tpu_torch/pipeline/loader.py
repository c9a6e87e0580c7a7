"""Host→device batch feed: pack RowBlocks into fixed shapes, copy to the
card.

Counterpart of ``dmlc_core_tpu/pipeline/device_loader.py``
(``DeviceLoader``), reduced to its python per-batch path: blocks from a
parser (or any iterable of :class:`RowBlock` s) are cut into
``batch_rows`` slices, partial slices carried across blocks in row
order, and each batch is packed with :func:`.packing.pack_flat` or
:func:`.packing.pack_rowmajor`.  The packed arrays are laid end to end in
one int32 host buffer (pinned when the target is a card) and moved with
one non-blocking copy; the batch's tensors are views of that one device
buffer.  A small ring of pinned buffers lets the host pack batch N+1
while batch N is still in flight; a buffer is reused only after the copy
that read it has finished (a CUDA event).

Batches carry the JAX loader's keys: ``ids``, ``vals``, ``segments``,
``row_ptr``, ``labels``, ``weights`` (flat) or ``ids``, ``vals``
(``[batch_rows, k_cap]``), ``labels``, ``weights`` (row-major).  The
fused wire, the pack and transfer threads and ``emit="host"`` stay with
the JAX package for now.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.row_block import RowBlock, concat_blocks
from ..utils.device import resolve_device
from ..utils.logging import check
from .packing import PackStats, batch_slices, pack_flat, pack_rowmajor

__all__ = ["DeviceLoader"]

_RING = 3                      # pinned host buffers in flight


def _layout(layout: str, rows: int, cap: int):
    """(key, dtype, shape) of each region of the one int32 buffer."""
    if layout == "flat":
        return [("ids", torch.int32, (cap,)),
                ("vals", torch.float32, (cap,)),
                ("segments", torch.int32, (cap,)),
                ("row_ptr", torch.int32, (rows + 1,)),
                ("labels", torch.float32, (rows,)),
                ("weights", torch.float32, (rows,))]
    return [("ids", torch.int32, (rows, cap)),
            ("vals", torch.float32, (rows, cap)),
            ("labels", torch.float32, (rows,)),
            ("weights", torch.float32, (rows,))]


class DeviceLoader:
    """Stream fixed-shape device batches from a parser.

    Parameters
    ----------
    source:         a :class:`~dmlc_core_tpu_torch.data.LibSVMParser` or
                    any iterable of RowBlocks (``before_first()`` and
                    ``close()`` are called on it when it has them).
    batch_rows:     rows per batch (static shape).
    nnz_cap:        flat layout: value capacity per batch; row-major
                    layout: per-row capacity ``k_cap``.
    layout:         ``"flat"`` (segment-sum ops, ragged-gather kernels) or
                    ``"rowmajor"`` (embed-bag kernels).
    id_mod:         feature hashing (``id % id_mod``); 0 keeps raw ids.
    device:         target device; the card unless ``"cpu"`` is given.

    The last, partial batch is padded (padding rows weigh 0).
    """

    def __init__(self, source, batch_rows: int, nnz_cap: int,
                 layout: str = "flat", id_mod: int = 0,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        check(layout in ("flat", "rowmajor"), f"bad layout {layout!r}")
        check(batch_rows > 0 and nnz_cap > 0,
              f"batch_rows and nnz_cap must be > 0, got {batch_rows}, "
              f"{nnz_cap}")
        self.source = source
        self.batch_rows = int(batch_rows)
        self.nnz_cap = int(nnz_cap)
        self.layout = layout
        self.id_mod = int(id_mod)
        self.device = resolve_device(device)
        self.stats = PackStats()
        self._regions = _layout(layout, self.batch_rows, self.nnz_cap)
        self._words = sum(int(np.prod(s)) for _, _, s in self._regions)
        self._pinned = self.device.type == "cuda"
        self._ring: List[torch.Tensor] = []
        self._events: List[Optional[torch.cuda.Event]] = []
        self._slot = 0
        self._gen: Optional[Iterator] = None

    # -- host side ------------------------------------------------------
    def _blocks(self) -> Iterator[RowBlock]:
        for blk in self.source:
            yield blk

    def _host_batches(self) -> Iterator[RowBlock]:
        """Blocks cut into ``batch_rows`` batches in source row order; a
        partial slice waits in the carry until later rows fill it."""
        carry: List[RowBlock] = []
        carried = 0
        for blk in self._blocks():
            for piece in batch_slices(blk, self.batch_rows):
                if not carried and piece.size == self.batch_rows:
                    yield piece
                    continue
                carry.append(piece)
                carried += piece.size
                if carried >= self.batch_rows:
                    merged = concat_blocks(carry)
                    yield merged.slice(0, self.batch_rows)
                    rest = merged.slice(self.batch_rows, merged.size)
                    carry = [rest] if rest.size else []
                    carried = rest.size
        if carried:
            yield concat_blocks(carry)

    def _pack(self, block: RowBlock) -> Dict[str, np.ndarray]:
        if self.layout == "flat":
            return pack_flat(block, self.batch_rows, self.nnz_cap,
                             self.stats, id_mod=self.id_mod)
        return pack_rowmajor(block, self.batch_rows, self.nnz_cap,
                             self.stats, id_mod=self.id_mod)

    def _host_buffer(self) -> Tuple[int, torch.Tensor]:
        """``(slot, buffer)``: the next int32 staging buffer, a fresh one
        for the CPU (slot -1), a pinned one from the ring for the card
        (waiting, if need be, for the copy that last read it)."""
        if not self._pinned:
            return -1, torch.empty(self._words, dtype=torch.int32)
        if len(self._ring) < _RING:
            self._ring.append(torch.empty(self._words, dtype=torch.int32,
                                          pin_memory=True))
            self._events.append(None)
        slot = self._slot
        self._slot = (slot + 1) % _RING
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        return slot, self._ring[slot]

    # -- transfer -------------------------------------------------------
    def _to_device(self, host: Dict[str, np.ndarray]) -> Dict[str,
                                                              torch.Tensor]:
        slot, buf = self._host_buffer()
        flat = buf.numpy()
        pos = 0
        for key, _, shape in self._regions:
            n = int(np.prod(shape))
            flat[pos:pos + n] = host[key].reshape(-1).view(np.int32)
            pos += n
        if self._pinned:
            dev = torch.empty(self._words, dtype=torch.int32,
                              device=self.device)
            dev.copy_(buf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._events[slot] = ev
        else:
            dev = buf
        out, pos = {}, 0
        for key, dtype, shape in self._regions:
            n = int(np.prod(shape))
            out[key] = dev[pos:pos + n].view(dtype).view(shape)
            pos += n
        return out

    # -- consumer side --------------------------------------------------
    def next_batch(self) -> Optional[Dict[str, torch.Tensor]]:
        if self._gen is None:
            self._gen = self._host_batches()
        block = next(self._gen, None)
        if block is None:
            return None
        return self._to_device(self._pack(block))

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def before_first(self) -> None:
        """Rewind to the first batch (the source is rewound too)."""
        self._gen = None
        if hasattr(self.source, "before_first"):
            self.source.before_first()

    def close(self) -> None:
        for ev in self._events:
            if ev is not None:
                ev.synchronize()
        self._ring, self._events, self._gen = [], [], None
        if hasattr(self.source, "close"):
            self.source.close()

    def __enter__(self) -> "DeviceLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
