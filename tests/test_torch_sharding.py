"""The port's logical sharding rules (``distributed/sharding.py``) and state
placements (``launch/shardings.py``) against the JAX package's, on the
CPU.

JAX's rules are made on ``jax.sharding.AbstractMesh``es of the two
production shapes (no devices) and its shardings taken of the full
configs' ``eval_shape`` trees; the port's are made on a ``DeviceMesh`` of
the same shape over a fake world of 256 or 512 ranks (this process is
rank 0; the world is torn down after each mesh) and taken of the trees
its models make under ``FakeTensorMode``.  JAX stacks a scanned group's
leaves with a leading repeat axis; the port keeps one dict a layer, so
each of its layer leaves is held against JAX's leaf of that layer's
place in the group, less the leading ``None``.  The specs are compared
entry for entry, and the DTensor placements against the specs.  All
exact: these are tables."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.launch import specs as jsp  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun, shardings as sh  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_SHAPES  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_flatten_with_keys  # noqa: E402
from torch_parity import jax_place  # noqa: E402

ARCHS = tuple(configs.list_archs())
MESHES = {"pod16x16": False, "pod2x16x16": True}


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    """``(jax AbstractMesh, port DeviceMesh)`` of one production shape;
    the port's over a fake world, destroyed after the module's tests of
    this mesh."""
    shape, names = PRODUCTION_SHAPES[MESHES[request.param]]
    with dryrun.fake_mesh(shape, names, device_type="cpu") as mesh:
        yield AbstractMesh(shape, names), mesh


def _norm(entry):
    """A spec entry with a 1-tuple read as its axis."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _jax_specs(tree, shardings) -> dict:
    """``{path: spec entries padded to the leaf's rank}`` of a JAX tree,
    paths as ``tree.tree_flatten_with_keys`` spells them."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree_util.tree_leaves(shardings)
    out = {}
    for (path, leaf), s in zip(leaves, shs):
        keys = tuple(getattr(e, "key", getattr(e, "idx", None))
                     for e in path)
        spec = tuple(s.spec) + (None,) * (leaf.ndim - len(s.spec))
        out[keys] = tuple(_norm(e) for e in spec)
    return out


def _compare(cfg_j, rules, tree, axes_fn, jtree, jshardings) -> int:
    """Hold every port leaf's spec and placements against JAX's; returns
    the leaves compared."""
    want = _jax_specs(jtree, jshardings)
    paths, leaves = tree_flatten_with_keys(tree)
    flat_places = list(_spec_leaves(sh.tree_shardings(rules, tree,
                                                      axes_fn)))
    assert len(paths) == len(flat_places)
    for path, leaf, pl in zip(paths, leaves, flat_places):
        spec = sh.leaf_spec(rules, axes_fn(path, leaf), tuple(leaf.shape))
        jpath, stacked = jax_place(cfg_j, path)
        jspec = want[jpath]
        if stacked:
            assert jspec[0] is None, (path, jspec)
            jspec = jspec[1:]
        assert tuple(_norm(e) for e in spec) == jspec, (path, spec, jspec)
        assert pl == sharding.placements_of(rules, spec), (path, pl)
    return len(paths)


def _spec_leaves(tree):
    """The leaves of a tree whose leaves are tuples (placements)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k])
    elif isinstance(tree, list) or (isinstance(tree, tuple) and
                                    hasattr(tree, "_fields")):
        for t in tree:
            yield from _spec_leaves(t)
    else:
        yield tree


@pytest.fixture(scope="module")
def trees():
    """Per arch: the JAX config and ``eval_shape`` trees (params, AdamW
    state, decode_32k cache) and the port's, made under
    ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    out = {}
    for arch in ARCHS:
        cfg_j, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        jm = jbuild(cfg_j)
        jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
        jo = jax.eval_shape(jadamw(3e-4).init, jp)
        shape = "long_500k" if jsp.cell_spec(cfg_j, "long_500k").runnable \
            else "decode_32k"
        jspec = jsp.cell_spec(cfg_j, shape)
        jc = jsp.decode_specs(cfg_j, jspec, jm)[0]
        jb = jsp.batch_specs(cfg_j, jsp.cell_spec(cfg_j, "train_4k"))
        with FakeTensorMode():
            m = build(cfg, "cpu")
            p = m.init(0)
            o = adamw(3e-4).init(p)
            c = sp.decode_specs(cfg, sp.cell_spec(cfg, shape), m)[0]
            b = sp.batch_specs(cfg, sp.cell_spec(cfg, "train_4k"), "cpu")
        out[arch] = (cfg_j, (jp, jo, jc, jb), (p, o, c, b))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_match_jax(meshes, trees, arch):
    """Parameters, AdamW state, the decode cache (``long_500k``'s for the
    sub-quadratic archs, whose batch of 1 replicates) and the train
    batch: every leaf's spec equal to JAX's ``PartitionSpec`` and its
    placements equal to the spec's."""
    amesh, mesh = meshes
    cfg_j, (jp, jo, jc, jb), (p, o, c, b) = trees[arch]
    jrules = jsharding.make_rules(amesh, n_heads=cfg_j.n_heads,
                                  n_kv_heads=cfg_j.n_kv_heads)
    rules = sharding.make_rules(mesh, n_heads=cfg_j.n_heads,
                                n_kv_heads=cfg_j.n_kv_heads)
    n = _compare(cfg_j, rules, p, sh.param_axes, jp,
                 jsh.param_shardings(jrules, jp))
    n += _compare(cfg_j, rules, o, sh.param_axes, jo,
                  jsh.opt_shardings(jrules, jo))
    n += _compare(cfg_j, rules, c, sh.cache_axes, jc,
                  jsh.cache_shardings(jrules, jc))
    n += _compare(cfg_j, rules, b, sh.batch_axes, jb,
                  jsh.batch_shardings(jrules, jb))
    assert n > 4 * cfg_j.n_layers


@pytest.mark.parametrize("heads", [(14, 2), (64, 8), (32, 32), (24, 8),
                                   (10, 1), (6, 6)])
def test_rules_table_matches_jax(meshes, heads):
    """``make_rules``' table entry for entry, and the fsdp/decode
    switches."""
    amesh, mesh = meshes
    for kw in ({}, {"shard_seq_decode": False, "fsdp_params": False}):
        jr = jsharding.make_rules(amesh, n_heads=heads[0],
                                  n_kv_heads=heads[1], **kw)
        r = sharding.make_rules(mesh, n_heads=heads[0], n_kv_heads=heads[1],
                                **kw)
        assert dict(r.table) == dict(jr.table)


@pytest.mark.parametrize("axes", [
    ("batch", "kv_seq", "kv_heads"), ("batch", "seq_act", "embed_act"),
    ("embed", "heads", None), ("experts", "embed", "ff"),
    ("vocab", "vocab"), ("batch", "embed"), ("kv_seq", "seq_act", "ff"),
    (None, "lru", "state"), ()])
def test_spec_claims_match_jax(meshes, axes):
    """``LogicalRules.spec``: a mesh axis claimed at most once (a later
    dim asking for a taken axis stays unsharded), tuples claimed in part,
    as JAX's ``PartitionSpec`` rule (which spells a 1-tuple as its
    axis)."""
    amesh, mesh = meshes
    jr = jsharding.make_rules(amesh, n_heads=16, n_kv_heads=16)
    r = sharding.make_rules(mesh, n_heads=16, n_kv_heads=16)
    assert tuple(map(_norm, r.spec(*axes))) == \
        tuple(map(_norm, jr.spec(*axes)))


def test_placements_of_tuple_axes(meshes):
    """A dim over ``("pod", "data")`` is ``Shard(i)`` on both mesh dims;
    the others ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = meshes
    r = sharding.make_rules(mesh, n_heads=16, n_kv_heads=16)
    names = mesh.mesh_dim_names
    pl = r.placements("batch", None, "ff")
    for name, p in zip(names, pl):
        assert p == (Shard(2) if name == "model" else Shard(0))
    assert r.placements(None, None) == (Replicate(),) * len(names)


def test_shard_hint_fallbacks(meshes):
    """``shard_hint`` (JAX's ``tests/test_distributed.py`` cases, held at
    the placements): extra logical axes beyond the rank are dropped, a dim
    the mesh extent does not divide is replicated, and with no rules or
    on a plain tensor it returns its input."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    _, mesh = meshes
    names = mesh.mesh_dim_names
    rules = sharding.make_rules(mesh, n_heads=4, n_kv_heads=2)
    rep = (Replicate(),) * mesh.ndim
    with FakeTensorMode():
        plain = torch.zeros((32, 16))
        assert sharding.shard_hint(plain, "batch", "ff") is plain
        x = distribute_tensor(torch.zeros((32, 16)), mesh, rep,
                              src_data_rank=None)
        assert sharding.shard_hint(x, "batch", "ff") is x     # no rules
        with sharding.use_rules(rules):
            y = sharding.shard_hint(x, "batch", "seq", "heads", "head_dim")
            assert y.shape == x.shape
            assert tuple(y.placements) == tuple(
                Replicate() if n == "model" else Shard(0) for n in names)
            z = sharding.shard_hint(
                distribute_tensor(torch.zeros((3, 5, 7)), mesh, rep,
                                  src_data_rank=None), "batch", "seq", "ff")
            assert z.shape == (3, 5, 7)
            assert tuple(z.placements) == rep
            w = sharding.shard_hint(x, "batch", "ff")
            assert tuple(w.placements) == tuple(
                Shard(1) if n == "model" else Shard(0) for n in names)


def test_param_axes_of_port_paths():
    """JAX's ``param_axes`` cases on the port's paths: a layer's ``wq``
    (no repeat axis) and an MoE expert weight."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = {"layers": [{"mixer": {"wq": torch.zeros((8, 4, 2))}}],
                "moe": {"w_gate": torch.zeros((4, 8, 16))}}
    paths, leaves = tree_flatten_with_keys(tree)
    got = [sh.param_axes(p, t) for p, t in zip(paths, leaves)]
    assert got == [("embed", "heads", None), ("experts", "embed", "ff")]

