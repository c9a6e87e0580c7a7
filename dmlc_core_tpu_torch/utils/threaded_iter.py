"""Threaded producer → consumer iterator.

Counterpart of ``dmlc_core_tpu/utils/threaded_iter.py`` (``ThreadedIter``,
the reference's ``include/dmlc/threadediter.h``): one producer thread
fills a bounded queue; consumed cells can be recycled to the producer;
``before_first`` resets the stream while the producer runs; ``destroy``
stops it mid-stream; an exception raised in the producer is re-raised in
the consumer.  The port's parser prefetch and its device loader's pack
and transfer stages are built on it.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Generic, Iterator, List, Optional, TypeVar

from .logging import DMLCError

__all__ = ["ThreadedIter"]

T = TypeVar("T")

JOIN_TIMEOUT_S = 10.0


class ThreadedIter(Generic[T]):
    """Background producer with a bounded queue and cell recycling.

    ``max_capacity`` bounds the queued items."""

    def __init__(self, max_capacity: int = 8) -> None:
        self.max_capacity = max(1, int(max_capacity))
        self._lock = threading.Condition()
        self._queue: List[T] = []
        self._free: List[T] = []
        self._produced_end = False
        self._consumed_end = False
        self._destroy = False
        self._reset_pending = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._next_fn: Optional[Callable[[Optional[T]], Optional[T]]] = None
        self._beforefirst_fn: Optional[Callable[[], None]] = None

    def init(self, next_fn: Callable[[Optional[T]], Optional[T]],
             beforefirst_fn: Optional[Callable[[], None]] = None,
             name: str = "ThreadedIter") -> None:
        """Start the producer thread.

        ``next_fn(reuse_cell)`` returns the next item (it may fill and
        return ``reuse_cell``, a recycled item) or None at the end of the
        stream; ``beforefirst_fn()`` rewinds the source."""
        if self._thread is not None:
            raise DMLCError("ThreadedIter.init called twice")
        self._next_fn = next_fn
        self._beforefirst_fn = beforefirst_fn
        self._thread = threading.Thread(target=self._producer_loop,
                                        name=name, daemon=True)
        self._thread.start()

    @classmethod
    def from_iterable_factory(cls, factory: Callable[[], Iterator[T]],
                              max_capacity: int = 8) -> "ThreadedIter[T]":
        """Wrap a restartable iterable (``factory`` is called per epoch)."""
        it = cls(max_capacity=max_capacity)
        state = {"iter": factory()}

        def next_fn(_cell: Optional[T]) -> Optional[T]:
            return next(state["iter"], None)

        def beforefirst_fn() -> None:
            state["iter"] = factory()

        it.init(next_fn, beforefirst_fn)
        return it

    # -- producer side --
    def _producer_loop(self) -> None:
        while True:
            with self._lock:
                while (not self._destroy and not self._reset_pending
                       and (self._produced_end
                            or len(self._queue) >= self.max_capacity)):
                    self._lock.wait()
                if self._destroy:
                    return
                if self._reset_pending:
                    self._free.extend(self._queue)
                    self._queue.clear()
                    try:
                        if self._beforefirst_fn is not None:
                            self._beforefirst_fn()
                        self._produced_end = False
                        self._consumed_end = False
                        self._error = None
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        self._error = e         # in the consumer
                        self._produced_end = True
                    self._reset_pending = False
                    self._lock.notify_all()
                    continue
                cell = self._free.pop() if self._free else None
            try:
                item = self._next_fn(cell)  # type: ignore[misc]
            except BaseException as e:  # noqa: BLE001 — re-raised in next()
                with self._lock:
                    self._error = e
                    self._produced_end = True
                    self._lock.notify_all()
                continue
            with self._lock:
                if self._reset_pending or self._destroy:
                    if item is not None:
                        self._free.append(item)
                    continue
                if item is None:
                    if cell is not None:
                        self._free.append(cell)
                    self._produced_end = True
                else:
                    self._queue.append(item)
                self._lock.notify_all()

    # -- consumer side --
    def next(self) -> Optional[T]:
        """The next item, or None at the end.  A consumer blocked here
        returns None when :meth:`destroy` fires, so chained stages unwind
        instead of waiting on a dead producer."""
        with self._lock:
            if self._consumed_end:
                return None
            while (not self._queue and not self._produced_end
                   and not self._destroy):
                self._lock.wait()
            if self._destroy and not self._queue:
                self._consumed_end = True
                return None
            if self._error is not None and not self._queue:
                err = self._error
                self._consumed_end = True
                raise DMLCError(
                    f"ThreadedIter producer failed: {err!r}") from err
            if self._queue:
                item = self._queue.pop(0)
                self._lock.notify_all()
                return item
            self._consumed_end = True
            return None

    def recycle(self, item: T) -> None:
        """Hand a consumed cell back to the producer for reuse."""
        with self._lock:
            self._free.append(item)
            self._lock.notify_all()

    def before_first(self) -> None:
        """Rewind to the beginning; blocks until the producer has reset."""
        with self._lock:
            if self._thread is None:
                raise DMLCError("ThreadedIter not initialized")
            self._reset_pending = True
            self._lock.notify_all()
            while self._reset_pending and not self._destroy:
                self._lock.wait()
            self._consumed_end = False

    def __iter__(self) -> Iterator[T]:
        while True:
            item = self.next()
            if item is None:
                return
            yield item

    # -- teardown --
    def destroy(self) -> None:
        """Stop the producer and join it (with a timeout)."""
        with self._lock:
            self._destroy = True
            self._lock.notify_all()
        if self._thread is not None:
            if self._thread is not threading.current_thread():
                self._thread.join(timeout=JOIN_TIMEOUT_S)
            self._thread = None

    def __enter__(self) -> "ThreadedIter[T]":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.destroy()

    def __del__(self) -> None:
        self.destroy()
