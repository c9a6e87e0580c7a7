"""``ls``/``cat``/``cp``/``stat`` over any registered URI scheme, and
``pack``/``unpack`` between line text and recordio.

Counterpart of ``dmlc_core_tpu/io/fscli.py`` (the JAX package's
``dmlc-fs``; the reference's ``test/filesys_test.cc`` driver)::

    python -m dmlc_core_tpu_torch.io.fscli ls  s3://bucket/dir
    python -m dmlc_core_tpu_torch.io.fscli cat hdfs://nn:9870/data/part-0
    python -m dmlc_core_tpu_torch.io.fscli cp  file:///tmp/in s3://bucket/out
    python -m dmlc_core_tpu_torch.io.fscli stat https://host/file.bin

``cp`` streams in 1 MiB chunks, so it runs the ranged reads and the
multipart writes the training path uses.  A failure prints one line
and exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from ..utils.logging import DMLCError
from .filesys import get_filesystem, open_seek_stream_for_read, open_stream
from .uri import URI

__all__ = ["main"]

_CHUNK = 1 << 20


def cmd_ls(uri_str: str) -> int:
    u = URI(uri_str)
    fs = get_filesystem(u)
    for info in fs.list_directory(u):
        kind = "d" if info.type == "dir" else "-"
        print(f"{kind} {info.size:>14d}  {info.path}")
    return 0


def cmd_stat(uri_str: str) -> int:
    fs = get_filesystem(URI(uri_str))
    info = fs.get_path_info(URI(uri_str))
    print(f"{info.type} {info.size} {info.path}")
    return 0


def cmd_cat(uri_str: str) -> int:
    with open_seek_stream_for_read(uri_str) as src:
        while True:
            chunk = src.read(_CHUNK)
            if not chunk:
                # flush HERE so a closed pipe raises inside main's handler,
                # not at interpreter-shutdown where it prints noise
                sys.stdout.buffer.flush()
                return 0
            sys.stdout.buffer.write(chunk)


def cmd_cp(src_uri: str, dst_uri: str) -> int:
    copied = 0
    with open_seek_stream_for_read(src_uri) as src, \
            open_stream(dst_uri, "w") as dst:
        while True:
            chunk = src.read(_CHUNK)
            if not chunk:
                break
            dst.write(chunk)
            copied += len(chunk)
    print(f"copied {copied} bytes {src_uri} -> {dst_uri}", file=sys.stderr)
    return 0


def cmd_pack(src_uri: str, dst_uri: str) -> int:
    """Each text line (newline stripped) becomes one recordio record —
    the im2rec-style list→.rec conversion, format-agnostic."""
    from .recordio import RecordIOWriter
    n = 0
    with open_seek_stream_for_read(src_uri) as src, \
            open_stream(dst_uri, "w") as dst:
        w = RecordIOWriter(dst)
        carry = b""
        while True:
            chunk = src.read(_CHUNK)
            if not chunk:
                break
            carry += chunk
            *lines, carry = carry.split(b"\n")
            for line in lines:
                w.write_record(line)
                n += 1
        if carry:
            w.write_record(carry)
            n += 1
    print(f"packed {n} records {src_uri} -> {dst_uri}", file=sys.stderr)
    return 0


def cmd_unpack(src_uri: str, dst_uri: str) -> int:
    """Inverse of pack: one text line per record."""
    from .recordio import RecordIOReader
    n = 0
    with open_seek_stream_for_read(src_uri) as src, \
            open_stream(dst_uri, "w") as dst:
        r = RecordIOReader(src)
        while True:
            rec = r.next_record()
            if rec is None:
                break
            dst.write(rec)
            dst.write(b"\n")
            n += 1
    print(f"unpacked {n} records {src_uri} -> {dst_uri}", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="dmlc-fs",
        description="ls/cat/cp/stat over any URI scheme "
                    "(file, http(s), s3, gs, hdfs, azure); pack/unpack "
                    "convert line-text <-> recordio")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ls").add_argument("uri")
    sub.add_parser("stat").add_argument("uri")
    sub.add_parser("cat").add_argument("uri")
    for name in ("cp", "pack", "unpack"):
        sp = sub.add_parser(name)
        sp.add_argument("src")
        sp.add_argument("dst")
    args = p.parse_args(argv)
    try:
        if args.cmd == "ls":
            return cmd_ls(args.uri)
        if args.cmd == "stat":
            return cmd_stat(args.uri)
        if args.cmd == "cat":
            return cmd_cat(args.uri)
        if args.cmd == "pack":
            return cmd_pack(args.src, args.dst)
        if args.cmd == "unpack":
            return cmd_unpack(args.src, args.dst)
        return cmd_cp(args.src, args.dst)
    except DMLCError as e:
        print(f"dmlc-fs: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # `dmlc-fs cat big | head`: downstream closed — exit quietly,
        # pointing stdout at devnull so interpreter shutdown can't re-raise
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
