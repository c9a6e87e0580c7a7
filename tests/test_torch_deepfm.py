"""The port's DeepFM, and FM on row-major batches, held against the JAX
package on the CPU.

Batches are packed once with the port's packers (bit-equal to the JAX
package's, see ``test_torch_pipeline.py``) and handed to both packages;
JAX-initialised parameters are carried across with ``params_from_jax``.
The JAX models run with ``engine="pallas"``, so their row-major FM terms
are the Pallas ``_fm_kernel`` in interpret mode with its custom VJP; the
port's row-major path goes through the ``torch.autograd.Function`` that
pairs the fm-terms kernels on the card (their plain versions here).

On flat batches the port takes ``s2 = Σ (v·x)²`` from one pass of the
ragged gather where the JAX DeepFM sums ``v²·x²`` against ``v*v``: the
same sum up to rounding, held here at the tolerance below.

Tolerances: ``rtol = 1e-5, atol = 1e-6`` for forward values and one
step's gradients (the same float32 terms summed in other orders);
``rtol = 1e-4`` for 5-step Adam loss trajectories, whose rounding
differences grow step by step; final parameters at ``rtol = 1e-4,
atol = 1e-6``.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
jnp = jax.numpy

from dmlc_core_tpu.models import deep as jdeep  # noqa: E402
from dmlc_core_tpu.models import sparse as jsparse  # noqa: E402
from dmlc_core_tpu.models import train as jtrain  # noqa: E402
from dmlc_core_tpu.ops import csr as jcsr  # noqa: E402
from dmlc_core_tpu_torch.data import RowBlock, parse_libsvm  # noqa: E402
from dmlc_core_tpu_torch.models import (DeepFM,  # noqa: E402
                                        FactorizationMachine, adam,
                                        make_train_step, params_from_jax)
from dmlc_core_tpu_torch.ops import csr_fm_terms  # noqa: E402
from dmlc_core_tpu_torch.pipeline import (pack_flat,  # noqa: E402
                                          pack_rowmajor)

F = 4096
D = 8
L = 2
ROWS, CAP, K_CAP = 16, 128, 8
TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ = dict(rtol=1e-4, atol=0)
PARAMS = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _no_engine_pin(monkeypatch):
    monkeypatch.delenv("DMLC_EMBED_ENGINE", raising=False)


def _text(rows: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(rows):
        n = int(rng.integers(2, 9))
        idx = np.sort(rng.choice(F + 8, size=n, replace=False))
        idx[0] = F + 3 if i % 5 == 0 else idx[0]  # an id past the table
        toks = b" ".join(b"%d:%.4f" % (j, v) for j, v in
                         zip(idx.tolist(), rng.random(n).tolist()))
        lines.append(b"%d " % (i & 1) + toks)
    return b"\n".join(lines) + b"\n"


def _batches(layout: str, n: int, seed: int = 0):
    d = parse_libsvm(_text(ROWS * n - 3, seed))       # last batch padded
    blk = RowBlock(d["offsets"], d["labels"], d["indices"], d["values"],
                   d["weights"])
    out = []
    for lo in range(0, blk.size, ROWS):
        piece = blk.slice(lo, min(lo + ROWS, blk.size))
        if layout == "flat":
            b = pack_flat(piece, ROWS, CAP)
            b.pop("row_ptr")
        else:
            b = pack_rowmajor(piece, ROWS, K_CAP)
        out.append(b)
    return out


def _to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _deepfm_pair(l2=1e-4, seed=0):
    jm = jdeep.DeepFM(F, D, L, l2=l2, engine="pallas")
    jp = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    # a non-zero linear term and biases, so every parameter is exercised
    rng = np.random.default_rng(seed)
    jp["w"] = (rng.normal(size=F) * 0.1).astype(np.float32)
    jp["v"] = jp["v"] * 30.0              # FM terms well above rounding
    jp["tower"]["b"] = (rng.normal(size=(L, D)) * 0.1).astype(np.float32)
    jp["head"]["b"] = np.float32(-0.02)
    jp["w0"] = np.float32(0.05)
    tm = DeepFM(F, D, L, l2=l2, device="cpu")
    tm.load_state_dict(params_from_jax(jp, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, jp), tm


def _fm_pair(seed=0):
    jm = jsparse.FactorizationMachine(F, D, l2=1e-4, engine="pallas")
    jp = _np_tree(jm.init(jax.random.PRNGKey(seed)))
    jp["w"] = (np.random.default_rng(seed).normal(size=F) * 0.1
               ).astype(np.float32)
    tm = FactorizationMachine(F, D, l2=1e-4, device="cpu")
    tm.load_state_dict(params_from_jax(jp, "cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, jp), tm


def test_deepfm_parameter_names_map_onto_the_jax_tree():
    jm, jp, tm = _deepfm_pair()
    sd = tm.state_dict()
    want = dict(_flat_items(_np_tree(jp)))
    assert set(sd) == set(want) == {"w0", "w", "v", "tower.w", "tower.b",
                                    "head.w", "head.b"}
    for k, v in want.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_deepfm_init_draws_from_the_generator_at_the_jax_scales():
    a, b = (DeepFM(F, D, L, device="cpu",
                   generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
    assert abs(float(a.v.detach().std()) - 0.01) < 1e-3
    assert abs(float(a.tower.w.detach().std()) - D ** -0.5) < 0.1
    assert float(a.w.detach().abs().sum()) == 0.0
    assert float(a.tower.b.detach().abs().sum()) == 0.0
    assert a.head.b.shape == () and a.w0.shape == ()


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
def test_deepfm_forward_matches_jax(layout):
    jm, jp, tm = _deepfm_pair()
    b = _batches(layout, 1)[0]
    want = np.asarray(jm.forward(jp, _to_jax(b)))
    got = tm(_to_torch(b))
    assert got.shape == (ROWS,)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # the FM part is not negligible next to the tower
    with torch.no_grad():
        _, s1, s2 = tm._terms(_to_torch(b))
    assert float((s1 * s1 - s2).sum(-1).abs().max()) > 1e-3


@pytest.mark.parametrize("layout", ["flat", "rowmajor"])
def test_deepfm_loss_grads_match_jax(layout):
    jm, jp, tm = _deepfm_pair()
    b = _batches(layout, 1)[0]
    jloss, jg = jax.value_and_grad(jm.loss)(jp, _to_jax(b))
    loss = tm.loss(_to_torch(b))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = dict(_flat_items(_np_tree(jg)))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], **TOL,
                                   err_msg=name)
        assert np.abs(want[name]).max() > 0, name


def test_deepfm_flat_one_pass_equals_two_embed_sums():
    """``csr_fm_terms``' ``Σ (v·x)²`` against the JAX DeepFM's
    ``csr_embed_sum(vals², v*v)``, and ``Σ v·x`` against
    ``csr_embed_sum``: equal up to rounding."""
    _, jp, tm = _deepfm_pair()
    b = _batches("flat", 1, seed=3)[0]
    ids, vals, segs = (b[k] for k in ("ids", "vals", "segments"))
    v = np.array(jp["v"])
    want1 = jcsr.csr_embed_sum(*map(jnp.asarray, (ids, vals, segs, v)), ROWS)
    want2 = jcsr.csr_embed_sum(*map(jnp.asarray, (ids, vals * vals, segs,
                                                 v * v)), ROWS)
    s1, s2 = csr_fm_terms(*map(torch.from_numpy, (ids, vals, segs, v)), ROWS)
    np.testing.assert_allclose(s1.numpy(), np.asarray(want1), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(want2), **TOL)


def _trajectory(jm, jp, tm, batches, steps=5):
    opt = optax.adam(1e-3)
    jstep = jtrain.make_train_step(jm, opt, donate=False)
    st = opt.init(jp)
    tstep = make_train_step(tm, adam(tm, 1e-3))
    jl, tl = [], []
    for i in range(steps):
        b = batches[i % len(batches)]
        jp, st, loss = jstep(jp, st, _to_jax(b))
        jl.append(float(loss))
        tl.append(float(tstep(_to_torch(b))))
    return np.array(jl), np.array(tl), jp


@pytest.mark.parametrize("model,layout", [("deepfm", "flat"),
                                          ("deepfm", "rowmajor"),
                                          ("fm", "rowmajor")])
def test_adam_trajectory_matches_optax(model, layout):
    jm, jp, tm = _deepfm_pair() if model == "deepfm" else _fm_pair()
    jl, tl, jp = _trajectory(jm, jp, tm, _batches(layout, 3))
    np.testing.assert_allclose(tl, jl, **TRAJ)
    assert jl[-1] < jl[0]
    want = dict(_flat_items(_np_tree(jp)))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   **PARAMS, err_msg=name)
