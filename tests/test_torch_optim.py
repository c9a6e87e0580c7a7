"""The port's optimizers (``Adam``, ``FTRL``; the plain versions of the
fused kernels of ``kernels/optim.py``) held against ``optax.adam`` and
the JAX package's ``ftrl`` on the CPU, and their states carried through
both packages' checkpoints.

Inputs come from a numpy seed: a param tree with a 0-d leaf, a vector and
a matrix whose row 2 always gets a zero gradient.  Tolerances: Adam's
params, ``mu`` and ``nu`` after 8 steps at ``rtol = 1e-5, atol = 1e-7``
(the same float32 operations in the same order; ``1 - b^count`` comes
from two ``pow`` implementations, XLA's and PyTorch's); ``count`` exact.
FTRL at ``rtol = 1e-5, atol = 1e-7``, and its zeros exact (an L1
threshold gives exact 0.0 in both).  Checkpoint round trips are exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
optax = pytest.importorskip("optax")
jnp = jax.numpy

from dmlc_core_tpu.models.ftrl import FTRLState, ftrl  # noqa: E402
from dmlc_core_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from dmlc_core_tpu_torch import CheckpointManager, DMLCError  # noqa: E402
from dmlc_core_tpu_torch.kernels import (adam_step,  # noqa: E402
                                         ftrl_step)
from dmlc_core_tpu_torch.models import (FTRL, Adam,  # noqa: E402
                                        adam_state_from_optax,
                                        adam_state_to_optax,
                                        ftrl_state_from_optax,
                                        ftrl_state_to_optax)

TOL = dict(rtol=1e-5, atol=1e-7)
STEPS = 8


class _Tree(torch.nn.Module):
    """The test's param tree: ``b`` (0-d), ``w`` [13], ``sub.v`` [6, 4]
    (nested, as DCNv2's ``cross``)."""

    def __init__(self, p):
        super().__init__()
        self.b = torch.nn.Parameter(torch.from_numpy(p["b"].copy()))
        self.w = torch.nn.Parameter(torch.from_numpy(p["w"].copy()))
        self.sub = torch.nn.Module()
        self.sub.v = torch.nn.Parameter(torch.from_numpy(p["sub"]["v"]
                                                         .copy()))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": np.array(rng.normal(), np.float32),
            "w": rng.normal(size=13).astype(np.float32),
            "sub": {"v": (rng.normal(size=(6, 4)) * 0.1).astype(np.float32)}}


def _grads(rng, scale=1.0, zero_row=True):
    """Gradients of very different sizes, some far below eps; row 2 of
    ``sub.v`` zero unless ``zero_row`` is False."""
    v = (rng.normal(size=(6, 4)) * 10.0 ** rng.integers(-9, 2, (6, 4))
         ).astype(np.float32) * scale
    if zero_row:
        v[2] = 0.0
    return {"b": np.array(rng.normal() * scale, np.float32),
            "w": (rng.normal(size=13) * scale).astype(np.float32),
            "sub": {"v": v}}


def _set_grads(module, g):
    module.b.grad = torch.tensor(g["b"])
    module.w.grad = torch.from_numpy(g["w"].copy())
    module.sub.v.grad = torch.from_numpy(g["sub"]["v"].copy())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v)


def _assert_tree(module_or_tensors, tree, tol=TOL, what=""):
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, tree)))
    got = (dict(module_or_tensors.named_parameters())
           if isinstance(module_or_tensors, torch.nn.Module)
           else module_or_tensors)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w, **tol,
                                   err_msg=f"{what} {name}")


def _named(module, tensors):
    return {name: t for (name, _), t in zip(module.named_parameters(),
                                            tensors)}


@pytest.mark.parametrize("lr", [1e-3, 5e-2])
def test_adam_matches_optax_over_8_steps(lr):
    p0 = _params()
    opt = optax.adam(lr)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = opt.init(jp)
    mod = _Tree(p0)
    topt = Adam(mod.parameters(), lr=lr)
    rng = np.random.default_rng(1)
    for i in range(STEPS):
        # row 2 of sub.v gets a gradient at the first step only
        g = _grads(rng, zero_row=i > 0)
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        _set_grads(mod, g)
        topt.step()
        topt.zero_grad()
        if i == 0:
            row = mod.sub.v.detach().numpy()[2].copy()
    adam_state, _ = st
    _assert_tree(mod, jp, what="params")
    _assert_tree(_named(mod, topt.mu), adam_state.mu, what="mu")
    _assert_tree(_named(mod, topt.nu), adam_state.nu, what="nu")
    assert topt.count.dtype == torch.int32 and topt.count.dim() == 0
    assert int(topt.count) == int(adam_state.count) == STEPS
    # the row kept moving on its 7 zero-gradient steps: Adam stays dense
    assert (mod.sub.v.detach().numpy()[2] != row).all()


def test_adam_none_grad_steps_like_a_zero_grad():
    p0 = _params()
    a, b = _Tree(p0), _Tree(p0)
    oa, ob = Adam(a.parameters(), lr=1e-2), Adam(b.parameters(), lr=1e-2)
    g = _grads(np.random.default_rng(2))
    for mod, opt in ((a, oa), (b, ob)):
        _set_grads(mod, g)
        opt.step()
        opt.zero_grad()
    _set_grads(a, g)
    a.w.grad = None                      # no gradient this step ...
    _set_grads(b, g)
    b.w.grad = torch.zeros(13)           # ... steps as a zero one
    oa.step()
    ob.step()
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert int(oa.count) == 2


def test_adam_count_saturates_at_int32_max():
    p = torch.nn.Parameter(torch.ones(3))
    opt = Adam([p], lr=1e-3)
    opt.count.fill_(2 ** 31 - 1)
    p.grad = torch.ones(3)
    opt.step()
    assert int(opt.count) == 2 ** 31 - 1
    assert torch.isfinite(p).all()


def test_zero_grad_keeps_or_drops():
    p = torch.nn.Parameter(torch.ones(3))
    opt = Adam([p])
    p.grad = torch.ones(3)
    opt.zero_grad(set_to_none=False)
    assert p.grad is not None and float(p.grad.abs().sum()) == 0.0
    opt.zero_grad()
    assert p.grad is None


@pytest.mark.parametrize("l1", [0.0, 0.5, 1.0])
def test_ftrl_matches_jax(l1):
    p0 = _params(3)
    tx = ftrl(alpha=0.1, beta=1.0, l1=l1, l2=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = tx.init(jp)
    mod = _Tree(p0)
    opt = FTRL(mod.parameters(), alpha=0.1, beta=1.0, l1=l1, l2=1.0)
    rng = np.random.default_rng(4)
    for _ in range(STEPS):
        g = _grads(rng, scale=0.5)
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        _set_grads(mod, g)
        opt.step()
    _assert_tree(mod, jp, what="w")
    _assert_tree(_named(mod, opt.z), st.z, what="z")
    _assert_tree(_named(mod, opt.n), st.n, what="n")
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jp)))
    got = {k: v.detach().numpy() for k, v in mod.named_parameters()}
    zeros = sum(int((w == 0).sum()) for w in want.values())
    for k in want:   # the coordinates L1 holds at 0 are exactly 0 in both
        np.testing.assert_array_equal(got[k] == 0, want[k] == 0, err_msg=k)
    if l1 >= 1.0:
        assert zeros > 0       # the threshold bites at the defaults
    # the zero-gradient row: z and n never move, so w sits at 0
    np.testing.assert_array_equal(opt.n[2].numpy()[2], 0.0)


def test_ftrl_defaults_are_the_jax_ones():
    import inspect
    ref = inspect.signature(ftrl).parameters
    ours = inspect.signature(FTRL).parameters
    for k in ("alpha", "beta", "l1", "l2"):
        assert ours[k].default == ref[k].default, k


@pytest.mark.parametrize("bad", [dict(alpha=0.0), dict(l1=-1.0),
                                 dict(l2=-0.5)])
def test_ftrl_rejects_bad_hyperparameters(bad):
    p = torch.nn.Parameter(torch.ones(3))
    opt = FTRL([p], **bad)
    p.grad = torch.ones(3)
    with pytest.raises(DMLCError, match="FTRL needs"):
        opt.step()


def test_optimizer_checks():
    p = torch.nn.Parameter(torch.ones(3))
    with pytest.raises(DMLCError, match="engine='kernel' needs CUDA"):
        Adam([p], engine="kernel")
    with pytest.raises(DMLCError, match="unknown engine"):
        FTRL([p], engine="triton")
    with pytest.raises(DMLCError, match="at least one parameter"):
        Adam([])
    count = torch.zeros((), dtype=torch.int32)
    with pytest.raises(DMLCError, match="differ in length"):
        adam_step([p], [], [p.detach()], [p.detach()], count, None, lr=1.0)
    with pytest.raises(DMLCError, match=r"grad\[0\]"):
        adam_step([p.detach()], [torch.ones(4)], [torch.zeros(3)],
                  [torch.zeros(3)], count, None, lr=1.0)
    with pytest.raises(DMLCError, match="count must be"):
        adam_step([p.detach()], [torch.ones(3)], [torch.zeros(3)],
                  [torch.zeros(3)], count.long(), None, lr=1.0)
    with pytest.raises(DMLCError, match="int32"):
        ftrl_step([p.detach()], [torch.ones(3, dtype=torch.int32)],
                  [torch.zeros(3)], [torch.zeros(3)])


# ---------------------------------------------------------------------------
# checkpoints, both directions
# ---------------------------------------------------------------------------

def _trained(kind):
    p0 = _params(5)
    mod = _Tree(p0)
    opt = Adam(mod.parameters(), lr=1e-2) if kind == "adam" else \
        FTRL(mod.parameters(), l1=0.5)
    rng = np.random.default_rng(6)
    for _ in range(3):
        _set_grads(mod, _grads(rng))
        opt.step()
    return p0, mod, opt


def test_adam_state_roundtrips_through_both_checkpoints(tmp_path):
    p0, mod, opt = _trained("adam")
    state = adam_state_to_optax(mod, opt)
    (count, mu, nu), empty = state
    assert count.dtype == np.int32 and int(count) == 3 and empty == ()
    CheckpointManager(str(tmp_path / "port")).save(3, {"opt_state": state})
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    template = {"opt_state": optax.adam(1e-2).init(jp)}
    step, got = JCheckpointManager(str(tmp_path / "port")).restore(
        template=template)
    adam_state, _ = got["opt_state"]
    assert type(adam_state).__name__ == "ScaleByAdamState"
    assert adam_state.count.dtype == np.int32 and int(adam_state.count) == 3
    _assert_tree(_named(mod, opt.mu), adam_state.mu, tol=dict(rtol=0, atol=0))
    # ... and back through a JAX checkpoint into a fresh optimizer, in
    # place (a captured graph holds the state's addresses)
    JCheckpointManager(str(tmp_path / "jax")).save(3, got)
    _, back = CheckpointManager(str(tmp_path / "jax")).restore()
    fresh = Adam(mod.parameters(), lr=1e-2)
    ptrs = [t.data_ptr() for t in fresh.mu + fresh.nu + [fresh.count]]
    adam_state_from_optax(mod, fresh, back["opt_state"])
    assert ptrs == [t.data_ptr() for t in fresh.mu + fresh.nu
                    + [fresh.count]]
    assert int(fresh.count) == 3
    for a, b in zip(fresh.mu + fresh.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)


def test_ftrl_state_roundtrips_through_both_checkpoints(tmp_path):
    p0, mod, opt = _trained("ftrl")
    state = ftrl_state_to_optax(mod, opt)
    CheckpointManager(str(tmp_path / "port")).save(3, {"opt_state": state})
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    template = {"opt_state": ftrl(l1=0.5).init(jp)}
    _, got = JCheckpointManager(str(tmp_path / "port")).restore(
        template=template)
    assert isinstance(got["opt_state"], FTRLState)
    _assert_tree(_named(mod, opt.z), got["opt_state"].z,
                 tol=dict(rtol=0, atol=0))
    _assert_tree(_named(mod, opt.n), got["opt_state"].n,
                 tol=dict(rtol=0, atol=0))
    JCheckpointManager(str(tmp_path / "jax")).save(3, got)
    _, back = CheckpointManager(str(tmp_path / "jax")).restore()
    fresh = FTRL(mod.parameters(), l1=0.5)
    ptrs = [t.data_ptr() for t in fresh.z + fresh.n]
    ftrl_state_from_optax(mod, fresh, back["opt_state"])
    assert ptrs == [t.data_ptr() for t in fresh.z + fresh.n]
    for a, b in zip(fresh.z + fresh.n, opt.z + opt.n):
        assert torch.equal(a, b)


def test_state_loading_checks_shapes():
    _, mod, opt = _trained("adam")
    (count, mu, nu), _ = adam_state_to_optax(mod, opt)
    mu["w"] = mu["w"][:5]
    with pytest.raises(DMLCError, match="optimizer state mu has no w"):
        adam_state_from_optax(mod, opt, ((count, mu, nu), ()))
    with pytest.raises(DMLCError, match="not an optax.adam state"):
        adam_state_from_optax(mod, opt, (count, mu))
    with pytest.raises(DMLCError, match="not an FTRL state"):
        ftrl_state_from_optax(mod, FTRL(mod.parameters()), (1, 2, 3))
    other = torch.nn.Linear(2, 2)
    with pytest.raises(DMLCError, match="not a parameter of the optimizer"):
        adam_state_to_optax(other, opt)
