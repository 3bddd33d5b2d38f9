"""Port parity of the optimizers (``repro_torch.optim``) with
``repro.optim.optimizers``: five updates on a dict tree, from the same
numpy parameters and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_parity import rng, to_numpy  # noqa: E402

SHAPES = {"w": (4, 3), "b": (3,), "block": {"k": (2, 5), "s": ()}}
CASES = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.momentum(0.1, beta=0.9),
    "nesterov": lambda m: m.nesterov(0.1, beta=0.9),
    "slow_momentum": lambda m: m.slow_momentum(0.7, beta=0.5),
    "adamw-f32": lambda m: m.adamw(1e-2, weight_decay=0.01),
    "adamw-bf16": lambda m: m.adamw(1e-2, weight_decay=0.01),
    "adamw-noclip": lambda m: m.adamw(1e-2, weight_decay=0.01,
                                      grad_clip=None),
}
CLIPPED = ("adamw-f32", "adamw-bf16")


def _draw(r, shapes):
    if isinstance(shapes, dict):
        return {k: _draw(r, v) for k, v in shapes.items()}
    return r.standard_normal(shapes).astype(np.float32)


def _as_f32(x):
    """A leaf of either package as float32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x.float()) if x.is_floating_point() else to_numpy(x)
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if jnp.issubdtype(
        x.dtype, jnp.floating) else x)


@pytest.mark.parametrize("name", list(CASES))
def test_five_updates_match_jax(name):
    """Parameters and every state leaf within rtol 1e-6 of JAX's after
    each of 5 updates, the step counter equal; bf16 parameters keep
    float32 master weights in both.

    AdamW's clip divides by the global norm's ``sqrt``, which XLA on the
    CPU does not round correctly (11 of 1,000 float32 inputs differ from
    the IEEE root in the last bit; PyTorch's is IEEE), so its scale may
    differ by one ulp; an entry of ``m`` that cancels (0.9·m + 0.1·g of
    opposite signs) magnifies that past rtol 1e-6.  AdamW's leaves are
    therefore held to rtol 1e-6 plus 1e-6 of the leaf's largest entry;
    with ``grad_clip=None`` they meet rtol 1e-6 alone."""
    r = rng(11)
    params = _draw(r, SHAPES)
    grads = [_draw(r, SHAPES) for _ in range(5)]
    bf16 = name.endswith("bf16")
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                           torch.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    tp = tree_map(lambda a: torch.from_numpy(a).to(tdt), params)
    jo, to = CASES[name](jopt), CASES[name](optim)
    js, ts = jo.init(jp), to.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    for g in grads:
        jp, js = jo.update(jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
                           js, jp)
        tp, ts = to.update(tree_map(lambda a: torch.from_numpy(a).to(tdt),
                                    g), ts, tp)
        assert int(ts.step) == int(js.step)
        for want, got in zip(jax.tree.leaves((jp, js.inner)),
                             tree_leaves((tp, ts.inner)), strict=True):
            want = _as_f32(want)
            atol = 1e-6 * np.abs(want).max() if name in CLIPPED else 0.0
            np.testing.assert_allclose(_as_f32(got), want, rtol=1e-6,
                                       atol=atol)
    assert all(leaf.dtype == tdt for leaf in tree_leaves(tp))


def test_updates_leave_their_inputs_unchanged():
    """A state handed in (a ``merge_state`` holder's momentum) is never
    written: every update is out of place."""
    p = {"w": torch.ones(3)}
    opt = optim.momentum(0.1, beta=0.5)
    state = opt.init(p)
    before = state.inner["w"].clone()
    _, new = opt.update({"w": torch.ones(3)}, state, p)
    assert torch.equal(state.inner["w"], before) and int(state.step) == 0
    assert int(new.step) == 1


def test_tree_leaves_in_jax_order():
    tree = {"b": (torch.tensor(1.0), torch.tensor(3.0)),
            "a": {"z": torch.tensor(2.0), "y": torch.tensor(4.0)}}
    assert [float(x) for x in tree_leaves(tree)] == [4.0, 2.0, 1.0, 3.0]
    jtree = {"b": (1.0, 3.0), "a": {"z": 2.0, "y": 4.0}}
    assert jax.tree.leaves(jtree) == [4.0, 2.0, 1.0, 3.0]
    doubled = tree_map(lambda x, y: x + y, tree, tree)
    assert float(doubled["a"]["y"]) == 8.0 and isinstance(doubled["b"],
                                                          tuple)
