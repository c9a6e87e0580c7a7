"""The port's libsvm parser, packing and device loader, held against the
JAX package on the CPU.

The same seeded libsvm text (in the shape of the benchmark suite's
generator: 5–39 sorted distinct ids per row, values U[0,1), labels
``i & 1``) goes through both packages.  All of this is integer and
float32 copying, so every comparison is ``array_equal``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.data.py_parsers import \
    parse_libsvm as jparse_libsvm  # noqa: E402
from dmlc_core_tpu.data.row_block import RowBlock as JRowBlock  # noqa: E402
from dmlc_core_tpu.pipeline import packing as jpacking  # noqa: E402
from dmlc_core_tpu_torch.data import (LibSVMParser, RowBlock,  # noqa: E402
                                      create_parser, parse_libsvm)
from dmlc_core_tpu_torch.pipeline import (DeviceLoader,  # noqa: E402
                                          PackStats, pack_flat,
                                          pack_rowmajor)
from dmlc_core_tpu_torch.utils.logging import DMLCError  # noqa: E402


def libsvm_text(rows: int, seed: int = 0, id_range: int = 1_000_000
                ) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        n = int(rng.integers(5, 40))
        idx = np.sort(rng.choice(id_range, size=n, replace=False))
        toks = b" ".join(b"%d:%.4f" % (j, v) for j, v in
                         zip(idx.tolist(), rng.random(n).tolist()))
        lines.append(b"%d " % (i & 1) + toks)
    return b"\n".join(lines) + b"\n"


def _jblock(d):
    return JRowBlock(offsets=d["offsets"], labels=d["labels"],
                     indices=d["indices"], values=d["values"],
                     weights=d["weights"])


def _rows(blocks):
    """Every row of an iterable of blocks as (label, weight, ids, vals)."""
    out = []
    for b in blocks:
        o = np.asarray(b.offsets)
        w = (np.asarray(b.weights) if getattr(b, "weights", None) is not None
             else np.ones(len(o) - 1, np.float32))
        for r in range(len(o) - 1):
            s = slice(int(o[r]), int(o[r + 1]))
            out.append((float(b.labels[r]), float(w[r]),
                        np.asarray(b.indices)[s].tolist(),
                        np.asarray(b.values)[s].tolist()))
    return out


def test_parse_libsvm_equals_jax_fallback_parser():
    text = (libsvm_text(50, seed=1)
            + b"1:0.5 3:2\n\nbad 1:2\n0 4 7:1.5 x:2 9:1\n-1 12:3e-2\n")
    got, want = parse_libsvm(text), jparse_libsvm(text)
    assert set(got) == set(want) - {"max_field"}
    for k in ("offsets", "labels", "weights", "indices", "values"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["bad_lines"] == want["bad_lines"] == 2
    assert got["max_index"] == want["max_index"]


@pytest.mark.parametrize("num_parts", [1, 3])
def test_parser_parts_cover_the_file_like_jax(tmp_path, num_parts):
    path = tmp_path / "d.libsvm"
    path.write_bytes(libsvm_text(300, seed=2))
    got, want = [], []
    for part in range(num_parts):
        p = create_parser(str(path), part, num_parts, "libsvm")
        p.chunk_bytes = 4096                      # several chunks per part
        got += _rows(p)
        p.close()
        jp = jcreate_parser(f"file://{path}", part, num_parts, "libsvm")
        want += _rows(c.get_block() for c in jp)
        jp.close()
    assert len(got) == len(want) == 300
    assert got == want


def test_parser_rejects_what_is_not_ported(tmp_path):
    with pytest.raises(DMLCError, match="not ported"):
        create_parser(str(tmp_path / "x"), parser_type="libfm")
    with pytest.raises(DMLCError, match="local files"):
        create_parser("s3://bucket/x")
    with pytest.raises(DMLCError, match="no such file"):
        create_parser(str(tmp_path / "missing"))


def _block_pair(text):
    d = parse_libsvm(text)
    ours = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                    d["weights"])
    return ours, _jblock(jparse_libsvm(text))


@pytest.mark.parametrize("nnz_cap", [4096, 300])          # 300: water-fill
@pytest.mark.parametrize("id_mod", [0, 1000])
def test_pack_flat_bit_equal_to_jax(nnz_cap, id_mod):
    ours, theirs = _block_pair(libsvm_text(37, seed=3))
    s1, s2 = PackStats(), jpacking.PackStats()
    for lo, hi in ((0, 16), (16, 37)):
        got = pack_flat(ours.slice(lo, hi), 24, nnz_cap, s1, id_mod=id_mod)
        want = jpacking.pack_flat(theirs.slice(lo, hi), 24, nnz_cap, s2,
                                  id_mod=id_mod)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert vars(s1) == vars(s2)
    assert (s1.truncated_values > 0) == (nnz_cap == 300)


@pytest.mark.parametrize("k_cap", [64, 12])               # 12: truncates
def test_pack_rowmajor_bit_equal_to_jax(k_cap):
    ours, theirs = _block_pair(libsvm_text(21, seed=4))
    s1, s2 = PackStats(), jpacking.PackStats()
    got = pack_rowmajor(ours, 32, k_cap, s1)
    want = jpacking.pack_rowmajor(theirs, 32, k_cap, s2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert vars(s1) == vars(s2)


def test_pack_refuses_ids_past_int32_without_id_mod():
    blk = RowBlock(np.array([0, 1], np.int64), np.zeros(1, np.float32),
                   np.array([2 ** 31], np.uint64), np.ones(1, np.float32))
    with pytest.raises(ValueError, match="id_mod"):
        pack_flat(blk, 4, 8)
    assert pack_flat(blk, 4, 8, id_mod=1000)["ids"][0] == 2 ** 31 % 1000


@pytest.mark.parametrize("layout,cap", [("flat", 700), ("rowmajor", 64)])
def test_loader_batches_equal_jax_device_loader(tmp_path, monkeypatch,
                                                layout, cap):
    from dmlc_core_tpu import native
    from dmlc_core_tpu.pipeline.device_loader import \
        DeviceLoader as JDeviceLoader
    # the JAX loader's numpy pack path pads every batch to nnz_cap (its
    # native packer sizes batches to an nnz bucket instead); the port's
    # loader takes the same path with engine="python"
    monkeypatch.setattr(native, "has_packer", lambda: False)
    path = tmp_path / "d.libsvm"
    path.write_bytes(libsvm_text(101, seed=5))
    parser = create_parser(str(path))
    parser.chunk_bytes = 2048                 # partial batches get carried
    with DeviceLoader(parser, 32, cap, layout=layout, device="cpu",
                      engine="python") as ld:
        got = [{k: v.numpy().copy() for k, v in b.items()} for b in ld]
        ld.before_first()
        again = [b["ids"].numpy().copy() for b in ld]
        assert ld.stats.rows == 2 * 101
    jl = JDeviceLoader(jcreate_parser(f"file://{path}", 0, 1, "libsvm"),
                       32, cap, layout=layout, prefetch=1, put_threads=1,
                       wire_compact=False, cache=None)
    try:
        want = [{k: np.asarray(v) for k, v in b.items()} for b in jl]
    finally:
        jl.close()
    assert len(got) == len(want) == 4
    for g, w, a in zip(got, want, again):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_array_equal(a, g["ids"])


def test_loader_carries_rows_across_an_iterable_source():
    d = parse_libsvm(libsvm_text(20, seed=6))
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"])
    ld = DeviceLoader([blk.slice(0, 7), blk.slice(7, 20)], 8, 64,
                      layout="rowmajor", device="cpu")
    batches = list(ld)
    assert len(batches) == 3 and batches[0]["ids"].shape == (8, 64)
    np.testing.assert_array_equal(batches[1]["labels"].numpy(),
                                  d["labels"][8:16])
    # the last batch is padded with rows of weight 0
    np.testing.assert_array_equal(batches[2]["weights"].numpy(),
                                  [1, 1, 1, 1, 0, 0, 0, 0])


def test_loader_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DMLCError, match="no CUDA device"):
        DeviceLoader(LibSVMParser(data=b"1 2:3\n"), 4, 8)
