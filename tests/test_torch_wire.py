"""The v3 compact wire in the port, held against the JAX package.

* the port's ``Packer`` / ``SpPacker(compact=True)`` emit the JAX native
  packers' bytes and metas;
* the port's plain v3 decode (``kernels.wire_decode.
  wire_decode_reference`` behind ``make_decoder``) equals the JAX
  ``make_decoder`` under ``jax.jit`` and the port's own v2 decode of the
  same batch, ``array_equal``: on packed batches (dictionary and raw
  values) and on synthetic buffers of every id width from 4 to 31 bits;
* a generative sweep of id spaces, value cardinalities and row counts
  through both loaders;
* ``_fused_words_meta`` against JAX's, and v3 pages written and replayed
  by the port's page cache.

Everything runs on the CPU (``device="cpu"``); the decode kernel is held
against the plain version in ``test_torch_cuda.py``.
"""

import importlib
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from dmlc_core_tpu import native as jnative  # noqa: E402
from dmlc_core_tpu.data import create_parser as jcreate_parser  # noqa: E402
from dmlc_core_tpu.pipeline import device_loader as jdl  # noqa: E402
from dmlc_core_tpu_torch.data import create_parser  # noqa: E402
from dmlc_core_tpu_torch.pipeline import DeviceLoader  # noqa: E402
from dmlc_core_tpu_torch.pipeline import loader as loader_mod  # noqa: E402
from test_torch_native import _blocks, lib  # noqa: E402,F401

# the module (the package's name ``wire_decode`` is the function)
wd = importlib.import_module("dmlc_core_tpu_torch.kernels.wire_decode")

KEYS = ("ids", "vals", "segments", "row_ptr", "labels", "weights")


def _text(rows, seed, ids_hi, vmode):
    """Seeded libsvm text: ``vmode`` binary / quantized (few distinct
    values: the dictionary regime) or continuous (the raw regime)."""
    rng = np.random.default_rng(seed)
    lines = []
    for r in range(rows):
        n = int(rng.integers(1, 7))
        hi = min(ids_hi, 1 << 20)
        idx = sorted(set(rng.integers(0, hi, n).tolist()))
        if r == 0 and ids_hi > hi:
            idx = sorted(set(idx + [ids_hi - 1]))
        if vmode == "binary":
            toks = [f"{j}:1" for j in idx]
        elif vmode == "quantized":
            toks = [f"{j}:{rng.integers(0, 16) * 0.25}" for j in idx]
        else:
            toks = [f"{j}:{rng.random():.7f}" for j in idx]
        lines.append(f"{r % 2} " + " ".join(toks))
    return ("\n".join(lines) + "\n").encode()


def _used(buf, rows, meta):
    return np.asarray(buf)[:loader_mod._fused_words_meta(rows, meta)]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the packers ---------------------------------------------------------------

@pytest.mark.parametrize("vmode", ["binary", "quantized", "continuous"])
@pytest.mark.parametrize("kind", ["packer", "sppack"])
def test_compact_packers_emit_jax_bytes(lib, vmode, kind):
    data = _text(700, 5, 1 << 20, vmode)
    rows, cap = 64, 1024

    def drain(mod, block):
        if kind == "packer":
            p = mod.Packer(rows, cap, compact=True)
            items = [(_used(b, rows, m).copy(), m) for b, m in p.feed(block)]
        else:
            p = mod.SpPacker(rows, cap, compact=True)
            items = [(_used(b, rows, m).copy(), m)
                     for b, m in p.feed_text(data)]
        tail = p.flush()
        if tail is not None:
            items.append((_used(tail[0], rows, tail[1]).copy(), tail[1]))
        p.close()
        return items

    ours, theirs = _blocks(data, pieces=1)
    got, want = drain(lib, ours[0]), drain(jnative, theirs[0])
    assert len(got) == len(want) > 3
    dict_bits = set()
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm == wm and (gm >> 32) & 0xFF
        dict_bits.add((gm >> 40) & 0xFF)
        np.testing.assert_array_equal(gb, wb)
    # the value regime the mode is there for
    assert (0 in dict_bits) == (vmode == "continuous")


def _decimal_text(rows, seed, per_row, pool=None):
    """Seeded libsvm text of ``per_row`` (a ``[lo, hi)`` range) values a
    row, printed with 4
    decimals (10,001 float32 patterns, whose low bits cluster), or drawn
    from ``pool`` distinct values printed with 6."""
    rng = np.random.default_rng(seed)
    vals = None if pool is None else np.sort(rng.random(pool))
    lines = []
    for r in range(rows):
        n = int(rng.integers(*per_row))
        idx = sorted(set(rng.integers(0, 1 << 20, n).tolist()))
        toks = (f"{j}:{rng.random():.4f}" if vals is None
                else f"{j}:{vals[rng.integers(0, pool)]:.6f}" for j in idx)
        lines.append(f"{r % 2} " + " ".join(toks))
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("case", ["decimal4", "rebuilds"])
@pytest.mark.parametrize("kind", ["packer", "sppack"])
def test_dictionary_hash_keeps_the_jax_bytes(lib, case, kind):
    """The port's v3 dictionary hashes a value to its slot otherwise than
    the JAX packer (the high bits of a 64-bit product); the bytes stay
    the JAX packer's.  ``decimal4``: two batches of the training text's
    shape (5-39 ``%.4f`` values a row: the patterns whose home slots the
    low-bits hash clustered), the dictionary carried across them;
    ``rebuilds``: one batch holding more than 8,192 distinct values, so
    the table grows twice (4,096 → 16,384 → 65,536 slots) while codes
    are handed out."""
    if case == "decimal4":
        rows, cap, nrows = 4096, 131072, 8192
        data = _decimal_text(nrows, 11, (5, 40))
    else:
        rows, cap, nrows = 2048, 65536, 2048
        data = _decimal_text(nrows, 12, (20, 21), pool=9500)

    def drain(mod, block):
        if kind == "packer":
            p = mod.Packer(rows, cap, compact=True)
            items = [(_used(b, rows, m).copy(), m) for b, m in p.feed(block)]
        else:
            p = mod.SpPacker(rows, cap, compact=True)
            items = [(_used(b, rows, m).copy(), m)
                     for b, m in p.feed_text(data)]
        tail = p.flush()
        if tail is not None:
            items.append((_used(tail[0], rows, tail[1]).copy(), tail[1]))
        p.close()
        return items

    ours, theirs = _blocks(data, pieces=1)
    got, want = drain(lib, ours[0]), drain(jnative, theirs[0])
    assert len(got) == len(want) >= (2 if case == "decimal4" else 1)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm == wm
        np.testing.assert_array_equal(gb, wb)
    # the first batch is dictionary-coded, and its dictionary outgrew two
    # tables (more than 8,192 entries besides the reserved 0.0)
    nnz, w, dbits = loader_mod._decode_meta(got[0][1])
    assert dbits == 14
    _, dict_off, _, rp_off = wd.v3_layout(rows, nnz, w, dbits)
    assert np.count_nonzero(got[0][0][dict_off:rp_off]) > 8192


@pytest.mark.parametrize("meta", [
    4096, 100, 1024 | (20 << 32), 1024 | (20 << 32) | (4 << 40),
    3 | (8 << 32) | (2 << 40), 131072 | (32 << 32) | (16 << 40),
    7 | (12 << 32)])
@pytest.mark.parametrize("rows", [1, 64, 4096])
def test_fused_words_meta_matches_jax(meta, rows):
    assert loader_mod._fused_words_meta(rows, meta) == \
        jdl._fused_words_meta(rows, meta)
    assert loader_mod._decode_meta(meta) == jdl._decode_meta(meta)


# -- the decode ------------------------------------------------------------------

def _host_batches(path, compact, rows=64, cap=1024, **kw):
    with DeviceLoader(create_parser(path, **kw), rows, cap, device="cpu",
                      emit="host", wire_compact=compact) as ld:
        return [(np.asarray(b)[:loader_mod._fused_words_meta(rows, m)]
                 .copy(), m) for _, b, m, _ in ld]


@pytest.mark.parametrize("vmode", ["binary", "quantized", "continuous"])
def test_v3_decode_equals_jax_and_v2(tmp_path, lib, vmode):
    path = tmp_path / "d.libsvm"
    path.write_bytes(_text(900, 7, 1 << 20, vmode))
    plain = _host_batches(str(path), False)
    compact = _host_batches(str(path), True)
    assert len(plain) == len(compact) > 3
    for (b2, m2), (b3, m3) in zip(plain, compact):
        assert (m3 >> 32) & 0xFF and len(b3) < len(b2)
        got = loader_mod.make_decoder(64, m3)(torch.from_numpy(b3))
        v2 = loader_mod.make_decoder(64, m2)(torch.from_numpy(b2))
        want = jax.jit(jdl.make_decoder(64, m3))(jax.numpy.asarray(b3))
        host = loader_mod._decode_on_host(b3, 64, m3)
        for k in KEYS:
            w = np.asarray(want[k])
            for name, t in (("plain", got), ("v2", v2), ("host", host)):
                a = _np(t[k])
                assert a.dtype == w.dtype and a.shape == w.shape, (name, k)
                np.testing.assert_array_equal(a, w, err_msg=f"{name} {k}")


def _pack_bits(values, width, nwords):
    """``values`` at ``width`` bits each, LSB first, into int32 words."""
    bits = ((values.astype(np.uint64)[:, None]
             >> np.arange(width, dtype=np.uint64)) & 1).astype(np.uint8)
    flat = np.zeros(nwords * 32, np.uint8)
    flat[:bits.size] = bits.reshape(-1)
    return np.packbits(flat, bitorder="little").view("<u4").view(np.int32)


def _synthetic_v3(rng, rows, nnz, w, dbits):
    """A v3 buffer built in numpy, its meta, and the arrays it holds."""
    n_real = int(rng.integers(0, nnz + 1))
    rp = np.sort(rng.integers(0, n_real + 1, rows + 1)).astype(np.int32)
    rp[0], rp[-1] = 0, n_real
    ids = rng.integers(0, 1 << w, nnz, dtype=np.int64)
    ids[n_real:] = 0
    code_off, dict_off, val_off, rp_off = wd.v3_layout(rows, nnz, w, dbits)
    iw = (nnz * w + 31) // 32
    parts = [_pack_bits(ids, w, iw)]
    if dbits:
        table = rng.standard_normal(1 << dbits).astype(np.float32)
        table[0] = 0.0
        codes = rng.integers(0, 1 << dbits, nnz)
        codes[n_real:] = 0
        parts += [_pack_bits(codes, dbits, dict_off - code_off),
                  table.view(np.int32)]
        vals = table[codes]
    else:
        vals = rng.standard_normal(nnz).astype(np.float32)
        vals[n_real:] = 0.0
        parts.append(vals.view(np.int32))
    labels = rng.integers(0, 2, rows).astype(np.float32)
    weights = rng.random(rows).astype(np.float32)
    parts += [rp, labels.view(np.int32), weights.view(np.int32)]
    buf = np.concatenate(parts).astype(np.int32)
    assert len(buf) == rp_off + 3 * rows + 1
    meta = nnz | (w << 32) | (dbits << 40)
    v2 = np.concatenate([ids.astype(np.int32), vals.view(np.int32), rp,
                         labels.view(np.int32), weights.view(np.int32)])
    return buf, meta, v2, ids.astype(np.int32), vals


@pytest.mark.parametrize("dbits", [0, 3, 8])
@pytest.mark.parametrize("w", range(4, 32))
def test_v3_decode_every_id_width(w, dbits):
    """Synthetic v3 buffers at id widths 4-31 (the packer emits 8-32 in
    nibble steps): the plain decode, the JAX decoder and the v2 decode of
    the same arrays agree bit for bit."""
    rng = np.random.default_rng(1000 * w + dbits)
    rows, nnz = 13, 301
    buf, meta, v2, ids, vals = _synthetic_v3(rng, rows, nnz, w, dbits)
    got = loader_mod.make_decoder(rows, meta)(torch.from_numpy(buf))
    np.testing.assert_array_equal(got["ids"].numpy(), ids)
    np.testing.assert_array_equal(got["vals"].numpy().view(np.int32),
                                  vals.view(np.int32))
    want = jax.jit(jdl.make_decoder(rows, meta))(jax.numpy.asarray(buf))
    plain = loader_mod.make_decoder(rows, nnz)(torch.from_numpy(v2))
    for k in KEYS:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(_np(got[k]), _np(plain[k]), err_msg=k)


def test_wire_decode_refuses_what_is_not_v3():
    from dmlc_core_tpu_torch.utils.logging import DMLCError
    buf = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(DMLCError, match="not a v3 meta"):
        wd.wire_decode(buf, 4, 8, 0, 0)
    with pytest.raises(DMLCError, match="shorter than its layout"):
        wd.wire_decode(buf, 40, 64, 20, 0)
    with pytest.raises(DMLCError, match="needs CUDA tensors"):
        wd.wire_decode(buf, 4, 8, 8, 0, engine="kernel")


ID_SPACES = [2, 1 << 7, 1 << 13, 1 << 20, (1 << 31) - 2]
VAL_MODES = ["binary", "quantized", "continuous"]


@pytest.mark.parametrize("ids_hi,vmode",
                         list(itertools.product(ID_SPACES, VAL_MODES)))
def test_wire_compact_sweep_through_both_loaders(tmp_path, lib, ids_hi,
                                                 vmode):
    """The spirit of tests/test_pipeline.py's compact-wire fuzz: every id
    space and value cardinality, row counts on every flush path; the
    port's v3 batches equal its v2 batches and the JAX loader's v3
    batches, array for array."""
    for nrows in (1, 127, 128, 300):
        path = tmp_path / f"f{nrows}.libsvm"
        path.write_bytes(_text(nrows, nrows + ids_hi % 97, ids_hi, vmode))

        def port(compact):
            with DeviceLoader(create_parser(str(path)), 128, 1024,
                              device="cpu", wire_compact=compact) as ld:
                return [{k: b[k].numpy() for k in KEYS} for b in ld]

        with jdl.DeviceLoader(jcreate_parser(str(path)), batch_rows=128,
                              nnz_cap=1024, wire_compact=True) as ld:
            theirs = [{k: np.asarray(b[k]) for k in KEYS} for b in ld]
        plain, compact = port(False), port(True)
        assert len(plain) == len(compact) == len(theirs) >= 1
        for a, b, c in zip(plain, compact, theirs):
            for k in KEYS:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                np.testing.assert_array_equal(b[k], c[k], err_msg=k)


# -- v3 pages --------------------------------------------------------------------

def test_v3_pages_replay_the_uncached_batches(tmp_path, lib):
    path = tmp_path / "p.libsvm"
    path.write_bytes(_text(900, 9, 1 << 20, "quantized"))
    pages = str(tmp_path / "p.pages")

    def epochs(n):
        out = []
        with DeviceLoader(create_parser(str(path)), 64, 1024, device="cpu",
                          wire_compact=True, cache=pages,
                          cache_queue_pages=64) as ld:
            for _ in range(n):
                out.append([{k: b[k].numpy() for k in KEYS} for b in ld])
                ld.before_first()
            return out, dict(ld.cache_stats)

    uncached = _host_batches(str(path), True)
    assert all((m >> 32) & 0xFF for _, m in uncached)
    (first, second, third), stats = epochs(3)
    # the rewind after the third epoch opens the page file once more
    assert stats["misses"] == 1 and stats["hits"] >= 2, stats
    want = [loader_mod._decode_on_host(b, 64, m) for b, m in uncached]
    assert len(first) == len(second) == len(third) == len(want)
    for batches in (first, second, third):
        for got, w in zip(batches, want):
            for k in KEYS:
                np.testing.assert_array_equal(got[k], w[k].numpy(),
                                              err_msg=k)
    # a v2 loader never serves the v3 file: its fingerprint differs
    with DeviceLoader(create_parser(str(path)), 64, 1024, device="cpu",
                      wire_compact=False, cache=pages) as ld:
        assert ld.cached_page_file() is None
