"""Filesystem abstraction with URI-scheme routing.

Counterpart of ``dmlc_core_tpu/io/filesys.py`` (the reference's
``src/io/filesys.h``, ``src/io.cc`` and ``src/io/local_filesys.cc``):
an abstract :class:`FileSystem` (``get_path_info``, ``list_directory``,
``open``, ``open_for_read``), one instance per scheme from
``FS_REGISTRY``, a breadth-first :func:`list_directory_recursive` (each
directory's entries sorted) and the :func:`open_stream` /
:func:`open_seek_stream_for_read` factories.  Streams are plain binary
file objects.

This module registers the local scheme (a bare path or ``file://``);
:mod:`.remote_filesys` registers ``http``, ``https``, ``s3``, ``gs``,
``hdfs`` and ``azure``.  A scheme nobody registered raises
:class:`DMLCError`.
"""

from __future__ import annotations

import glob as _glob
import os
import sys
from dataclasses import dataclass
from typing import BinaryIO, List

from ..utils.logging import DMLCError, check
from ..utils.registry import Registry
from .uri import URI

__all__ = [
    "FileInfo", "FileSystem", "LocalFileSystem", "get_filesystem",
    "open_stream", "open_seek_stream_for_read", "list_directory_recursive",
    "read_full", "FS_REGISTRY",
]

FS_REGISTRY = Registry.get("FileSystem")


@dataclass
class FileInfo:
    """A path, its size in bytes and its type (``'file'`` or ``'dir'``)."""
    path: str
    size: int
    type: str


class FileSystem:
    """The interface every scheme implements."""

    def get_path_info(self, uri: URI) -> FileInfo:
        raise NotImplementedError

    def list_directory(self, uri: URI) -> List[FileInfo]:
        raise NotImplementedError

    def open(self, uri: URI, mode: str) -> BinaryIO:
        """A (seekable where possible) binary stream; mode in {'r','w','a'}."""
        raise NotImplementedError

    def open_for_read(self, uri: URI) -> BinaryIO:
        """A seekable read stream."""
        return self.open(uri, "r")

    def exists(self, uri: URI) -> bool:
        try:
            self.get_path_info(uri)
            return True
        except (DMLCError, OSError):
            return False

    def delete(self, uri: URI) -> None:
        raise DMLCError(f"delete not supported for scheme "
                        f"{uri.protocol or 'local'!r}")


def list_directory_recursive(fs: FileSystem, uri: URI) -> List[FileInfo]:
    """Every file under ``uri``, breadth first, each directory sorted."""
    out: List[FileInfo] = []
    queue = [uri]
    while queue:
        u = queue.pop(0)
        for info in fs.list_directory(u):
            if info.type == "dir":
                queue.append(URI(info.path))
            else:
                out.append(info)
    return out


class LocalFileSystem(FileSystem):
    """Local files; the path ``-`` (or empty) is stdin to read and stdout
    to write, as in the reference's ``local_filesys.cc``."""

    def _path(self, uri: URI) -> str:
        return uri.name if uri.protocol else uri.raw

    def get_path_info(self, uri: URI) -> FileInfo:
        path = self._path(uri)
        try:
            st = os.stat(path)
        except FileNotFoundError as e:
            raise DMLCError(f"no such file: {path}") from e
        except OSError as e:
            raise DMLCError(f"LocalFileSystem.get_path_info: {e}") from e
        return FileInfo(path=path, size=st.st_size,
                        type="dir" if os.path.isdir(path) else "file")

    def list_directory(self, uri: URI) -> List[FileInfo]:
        path = self._path(uri)
        try:
            names = sorted(os.listdir(path))
        except OSError as e:
            raise DMLCError(f"LocalFileSystem.list_directory: {e}") from e
        out = []
        for n in names:
            p = os.path.join(path, n)
            st = os.stat(p)
            out.append(FileInfo(path=p, size=st.st_size,
                                type="dir" if os.path.isdir(p) else "file"))
        return out

    def open(self, uri: URI, mode: str) -> BinaryIO:
        path = self._path(uri)
        if path in ("-", ""):
            return sys.stdin.buffer if mode == "r" else sys.stdout.buffer
        check(mode in ("r", "w", "a"), f"bad open mode {mode!r}")
        try:
            return open(path, mode + "b")
        except OSError as e:
            raise DMLCError(
                f"LocalFileSystem.open({path!r}, {mode!r}): {e}") from e

    def delete(self, uri: URI) -> None:
        try:
            os.unlink(self._path(uri))
        except OSError as e:
            raise DMLCError(f"LocalFileSystem.delete: {e}") from e

    def glob(self, pattern: str) -> List[str]:
        """Wildcard expansion (``*``, ``?``), sorted."""
        return sorted(_glob.glob(pattern))


_local = LocalFileSystem()
FS_REGISTRY.register("file", description="local filesystem")(lambda: _local)
FS_REGISTRY.register("", description="local filesystem (bare path)")(
    lambda: _local)


def get_filesystem(uri: URI) -> FileSystem:
    """The filesystem of ``uri``'s scheme."""
    entry = FS_REGISTRY.find(uri.scheme)
    if entry is None:
        raise DMLCError(
            f"unknown filesystem scheme {uri.scheme!r} in {uri.raw!r}; "
            f"registered: {FS_REGISTRY.list_names()}")
    return entry()


def open_stream(uri_str: str, mode: str) -> BinaryIO:
    """A stream over ``uri_str`` (the reference's ``Stream::Create``)."""
    uri = URI(uri_str)
    return get_filesystem(uri).open(uri, mode)


def read_full(stream, n: int) -> bytes:
    """``n`` bytes of ``stream``, fewer only at its end.  A raw stream's
    ``read`` may return less than asked (a remote stream's stops where
    its buffer does), so this reads on until ``n`` or the end; the JAX
    package reads once, and so fails on a remote file larger than one
    2 MiB fill (ROADMAP queue C)."""
    data = stream.read(n)
    while len(data) < n:
        more = stream.read(n - len(data))
        if not more:
            break
        data += more
    return data


def open_seek_stream_for_read(uri_str: str) -> BinaryIO:
    """A seekable read stream (the reference's ``SeekStream::CreateForRead``)."""
    uri = URI(uri_str)
    return get_filesystem(uri).open_for_read(uri)
