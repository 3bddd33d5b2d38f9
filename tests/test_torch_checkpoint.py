"""Port parity of the checkpoint manager (``repro_torch.checkpoint``).

The port's counterparts of ``tests/test_runtime.py::TestCheckpoint`` and
``tests/test_resilience.py::TestCheckpointHardening`` (all but the
torn-write injection, which comes with the fault plans, ROADMAP item
13), the leaf names against ``jax.tree_util.keystr``, and the format
across packages: a checkpoint that JAX's ``CheckpointManager`` writes
restores in the port bit for bit, and the reverse.  Inputs are made with
numpy from a seed; every comparison is bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    CheckpointManager)
from repro_torch.checkpoint.manager import host_copy  # noqa: E402
from repro_torch.optim.optimizers import OptState  # noqa: E402
from repro_torch.tree import tree_flatten_with_names  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_torch  # noqa: E402


def _jax_names(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [jax.tree_util.keystr(p) for p, _ in flat]


def _trees(seed: int = 0):
    """The same trees in numpy, for both packages: the shapes of the
    trainer's path (a bare state, a minibatch ``(state, counter)``, the
    SlowMo momentum, the EF buffer at cadence 1 and k, the v2 layout)."""
    r = rng(seed)
    w = r.standard_normal(8).astype(np.float32)
    counter = np.float32(12.0)
    mom_step, mom = np.int32(3), r.standard_normal(8).astype(np.float32)
    ef1 = {"g": r.standard_normal((1, 8)).astype(np.float32),
           "loss": r.standard_normal((1,)).astype(np.float32)}
    efk = r.standard_normal((1, 8)).astype(np.float32)
    return {
        "bare": lambda T, O: T(w),
        "dict": lambda T, O: {"w": T(w), "opt": {"m": T(mom), "n": T(ef1[
            "loss"])}},
        "tuple": lambda T, O: (T(w), T(counter)),
        "optstate": lambda T, O: O(T(mom_step), T(mom)),
        "v2, cadence 1": lambda T, O: {
            "model": (T(w), T(counter)),
            "merge_error": {k: T(v) for k, v in ef1.items()},
            "merge_momentum": O(T(mom_step), T(mom))},
        "v2, cadence k": lambda T, O: {
            "model": T(w), "merge_error": T(efk),
            "merge_momentum": O(T(mom_step), {"w": T(mom)})},
    }


def _as_jax(x):
    return jnp.asarray(np.asarray(x))


def _as_torch(x):
    return to_torch(np.asarray(x))


CASES = list(_trees())


# -- the names ---------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_leaf_names_equal_jax_keystr(case):
    """``tree_flatten_with_names`` spells every leaf's path as JAX's
    ``keystr`` does, in JAX's leaf order."""
    build = _trees()[case]
    names, leaves = tree_flatten_with_names(build(_as_torch, OptState))
    assert names == _jax_names(build(_as_jax, JOptState))
    jleaves = jax.tree.leaves(build(_as_jax, JOptState))
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert_bits_equal(a, np.asarray(b))


# -- across packages ----------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_jax_checkpoint_restores_in_the_port_bit_for_bit(case, tmp_path):
    build = _trees(1)[case]
    jtree = build(_as_jax, JOptState)
    JManager(str(tmp_path), async_save=False).save(
        7, jtree, extra={"data_step": 7, "merge_compression": None})
    template = build(lambda x: torch.zeros_like(_as_torch(x)), OptState)
    out, extra = CheckpointManager(str(tmp_path)).restore(7, template)
    assert extra == {"data_step": 7, "merge_compression": None}
    _, got = tree_flatten_with_names(out)
    for a, b in zip(got, jax.tree.leaves(jtree)):
        assert_bits_equal(a, np.asarray(b))
    assert type(out) is type(template)


@pytest.mark.parametrize("case", CASES)
def test_port_checkpoint_restores_in_jax_bit_for_bit(case, tmp_path):
    build = _trees(2)[case]
    tree = build(_as_torch, OptState)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(9, tree, extra={"cursor": 9})
    mgr.wait()
    template = build(lambda x: jnp.zeros_like(_as_jax(x)), JOptState)
    out, extra = JManager(str(tmp_path)).restore(9, template)
    assert extra == {"cursor": 9}
    for a, b in zip(jax.tree.leaves(out), tree_flatten_with_names(tree)[1]):
        assert_bits_equal(b, np.asarray(a))


def test_manifest_matches_jax_field_for_field(tmp_path):
    """The same tree saved by both packages: equal manifests but for the
    time, and equal payload arrays."""
    build = _trees(3)["v2, cadence 1"]
    JManager(str(tmp_path / "jax"), async_save=False).save(
        4, build(_as_jax, JOptState), extra={"a": 1})
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        4, build(_as_torch, OptState), extra={"a": 1})
    metas, payloads = [], []
    for side in ("jax", "port"):
        path = tmp_path / side / "step_0000000004"
        metas.append(json.loads((path / "manifest.json").read_text()))
        with np.load(path / "arrays.npz") as data:
            payloads.append({k: data[k] for k in data.files})
    for m in metas:
        m.pop("time")
        m.pop("checksums")
    assert metas[0] == metas[1]
    assert sorted(payloads[0]) == sorted(payloads[1])
    for k in payloads[0]:
        assert_bits_equal(payloads[1][k], payloads[0][k])


# -- the manager (tests/test_runtime.py::TestCheckpoint) ----------------------


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "opt": {"m": torch.ones(4), "step": torch.tensor(3)}}
    mgr.save(7, state, extra={"cursor": 7})
    out, extra = mgr.restore(7, {"w": torch.zeros(2, 3),
                                 "opt": {"m": torch.zeros(4),
                                         "step": torch.tensor(0)}})
    assert_bits_equal(out["w"], state["w"])
    assert_bits_equal(out["opt"]["step"], state["opt"]["step"])
    assert extra["cursor"] == 7


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    s = {"w": torch.zeros(3)}
    for step in (1, 5, 9):
        mgr.save(step, s)
    mgr.wait()
    assert mgr.latest_step() == 9


def test_async_save_copies_before_returning(tmp_path):
    """A CPU tensor updated in place after ``save`` returns does not reach
    the file: the host copy is a copy (``.numpy()`` would share)."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.arange(4.0)
    mgr.save(0, w)
    w.add_(100.0)
    mgr.wait()
    out, _ = mgr.restore(0, torch.zeros(4))
    assert_bits_equal(out, torch.arange(4.0))
    assert not np.shares_memory(host_copy(w), w.numpy())


@pytest.mark.parametrize("keep,keep_every,want", [
    (2, 0, [4, 5]),
    (2, 3, [0, 3, 4, 5]),
    (1, 2, [0, 2, 4, 5]),
])
def test_retention(tmp_path, keep, keep_every, want):
    mgr = CheckpointManager(str(tmp_path), keep=keep, keep_every=keep_every,
                            async_save=False)
    s = {"w": torch.zeros(())}
    for step in range(6):
        mgr.save(step, s)
    assert mgr.steps() == want


def test_structure_mismatch_raises_value_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"a": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure"):
        mgr.restore(0, {"b": torch.zeros(2)})


def test_placer_called_per_leaf_with_jax_names(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"model": (torch.arange(4.0), torch.tensor(2.0)),
            "merge_momentum": OptState(torch.tensor(1, dtype=torch.int32),
                                       torch.ones(4))}
    mgr.save(3, tree)
    seen = []

    def placer(name, host):
        seen.append(name)
        return torch.from_numpy(host) * 2

    out, _ = mgr.restore(3, tree, placer=placer)
    assert seen == _jax_names(
        {"model": (jnp.zeros(4), jnp.zeros(())),
         "merge_momentum": JOptState(jnp.zeros((), jnp.int32),
                                     jnp.zeros(4))})
    assert_bits_equal(out["model"][0], torch.arange(4.0) * 2)
    assert isinstance(out["merge_momentum"], OptState)


def test_restore_takes_the_template_dtype_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"a": torch.arange(3, dtype=torch.int32),
                 "b": torch.ones(2, dtype=torch.float64)})
    out, _ = mgr.restore(0, {"a": torch.zeros(3, dtype=torch.int64),
                             "b": torch.zeros(2, dtype=torch.float32)})
    assert out["a"].dtype == torch.int64 and out["b"].dtype == torch.float32
    assert out["a"].device == torch.device("cpu")
    with pytest.raises(TypeError, match="tensor"):
        mgr.restore(0, {"a": 0.0, "b": torch.zeros(2)})


def test_bf16_leaf_is_refused_naming_lm_training(tmp_path):
    """Refused until LM training (ROADMAP A18.7) brought bf16 states: a
    bf16 leaf is now stored as its bit patterns (npz dtype V2, as JAX's
    writer stores it; tests/test_torch_lm_train.py holds the bytes), and a
    dtype the format has no bytes for is still refused."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    with pytest.raises(TypeError, match="bf16 bit patterns"):
        mgr.save(0, {"w": torch.zeros(2, dtype=torch.complex64)})
    assert mgr.steps() == []
    w = torch.tensor([1.5, -0.0], dtype=torch.bfloat16)
    assert host_copy(w).dtype == np.dtype("V2")
    mgr.save(0, {"w": w})
    out, _ = mgr.restore(0, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert torch.equal(out["w"].view(torch.int16), w.view(torch.int16))


# -- hardening (tests/test_resilience.py::TestCheckpointHardening) -----------


def _save_one(tmp_path, step=0, async_save=False):
    m = CheckpointManager(str(tmp_path), async_save=async_save)
    state = {"w": torch.arange(6.0), "n": torch.tensor(3)}
    m.save(step, state, extra={"tag": step})
    m.wait()
    return m, state


def test_atomic_publish_leaves_no_tmp(tmp_path):
    _save_one(tmp_path)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_checksum_catches_corruption(tmp_path):
    m, state = _save_one(tmp_path)
    assert m.validate(0)
    arrays = os.path.join(m._step_path(0), "arrays.npz")
    with open(arrays, "r+b") as f:
        f.seek(os.path.getsize(arrays) // 2)
        f.write(b"\xde\xad\xbe\xef")
    assert not m.validate(0)
    with pytest.raises(CheckpointCorruptError):
        m.restore(0, state)
    assert issubclass(CheckpointCorruptError, RuntimeError)
    assert not issubclass(CheckpointCorruptError, ValueError)


def test_restore_latest_quarantines_and_falls_back(tmp_path):
    m, state = _save_one(tmp_path, step=0)
    m.save(1, state, extra={"tag": 1})
    m.wait()
    arrays = os.path.join(m._step_path(1), "arrays.npz")
    with open(arrays, "r+b") as f:
        f.truncate(os.path.getsize(arrays) // 2)   # a torn write
    with pytest.warns(RuntimeWarning, match="quarantined"):
        step, restored, extra = m.restore_latest(state)
    assert step == 0 and extra["tag"] == 0
    assert_bits_equal(restored["w"], state["w"])
    assert m.steps() == [0]
    assert [d for d in os.listdir(tmp_path) if ".corrupt" in d]


def test_legacy_checkpoint_without_checksums_validates(tmp_path):
    m, state = _save_one(tmp_path)
    mpath = os.path.join(m._step_path(0), "manifest.json")
    with open(mpath) as f:
        meta = json.load(f)
    del meta["checksums"]
    with open(mpath, "w") as f:
        json.dump(meta, f)
    assert m.validate(0)
    _, extra = m.restore(0, state)
    assert extra["tag"] == 0


def test_background_write_failure_surfaces_at_wait(tmp_path, monkeypatch):
    m, state = _save_one(tmp_path, step=0, async_save=True)
    assert m.latest_step() == 0

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    m.save(1, state)                   # returns; the failure is parked
    with pytest.raises(OSError, match="disk full"):
        m.wait()
    assert m.latest_step() == 0        # never published
    m.save(2, state)
    with pytest.raises(OSError, match="disk full"):
        m.save(3, state)               # surfaces at save() too
    assert m.latest_step() == 0
