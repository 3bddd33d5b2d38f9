"""The port's dry runs (``launch/specs.py``, ``launch/dryrun.py``,
``launch/dryrun_pim.py``) and the kernel wrappers' fake paths, on the
CPU (``launch.train``'s mesh flags are held in
``test_torch_lm_train.py``).

* Specs: ``cell_spec``, ``batch_specs`` and ``decode_specs`` equal to
  JAX's for all 40 (arch, shape) pairs (shapes, dtypes, skip reasons;
  the cache leaf for leaf, JAX's stacked leaves less their repeat axis).
* Cells: each arch's smoke config, prefill and decode at batch 8 × 64
  on a fake (2, 2, 2) ``("pod", "data", "model")`` mesh gives ``OK``
  (the train cells are in ``test_torch_dryrun_train.py``); a
  ``long_500k`` full-attention cell gives ``SKIP`` with JAX's reason;
  a rank's argument bytes are the sum of its local shards.
* ``dryrun_pim``: logreg at cadence 1 and 8 on the (16, 16) mesh, the
  merge's collective once a round, the overlap check.
* Fake paths: under ``FakeTensorMode`` each wrapper returns its plain
  version's shapes and dtypes, charges what a launch charges and counts
  no launch; a real CPU tensor runs the plain version, and a ``DTensor``
  is refused.
* ``RankCounter`` wraps DTensor's sharding propagator while active, and
  refuses to count where none of its method names exists.

Every fake world is started and destroyed inside the call that needs it
(``dryrun.fake_mesh``), so none outlives a test."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jsp  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import build as kbuild, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fxp_matmul as fxp  # noqa: E402
from repro_torch.kernels import kmeans_assign as km  # noqa: E402
from repro_torch.kernels import lut_activation as lut  # noqa: E402
from repro_torch.kernels import split_hist as shist  # noqa: E402
from repro_torch.launch import dryrun, dryrun_pim  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.tree import tree_flatten_with_keys  # noqa: E402
from torch_parity import jax_place  # noqa: E402

ARCHS = tuple(configs.list_archs())
SHAPES = tuple(sp.SHAPES)
POD = ((2, 2, 2), ("pod", "data", "model"))


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, shape):
    """The cell, its batch stand-ins and its decode cache, token and
    position: JAX's shapes and dtypes, JAX's skip reason word for
    word."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg_j, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jspec, spec = jsp.cell_spec(cfg_j, shape), sp.cell_spec(cfg, shape)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    jb = jsp.batch_specs(cfg_j, jspec)
    b = sp.batch_specs(cfg, spec)
    assert {k: (tuple(v.shape), _dt(v)) for k, v in b.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jb.items()}
    assert all(v.is_meta for v in b.values())
    if spec.kind != "decode" or not spec.runnable:
        return
    jcache, jtok, jpos = jsp.decode_specs(cfg_j, jspec, jbuild(cfg_j))
    with FakeTensorMode():
        cache, tok, pos = sp.decode_specs(cfg, spec, build(cfg, "cpu"))
    assert (tuple(tok.shape), _dt(tok)) == (jtok.shape, str(jtok.dtype))
    assert (tuple(pos.shape), _dt(pos)) == (jpos.shape, str(jpos.dtype))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
        keys = tuple(getattr(e, "key", getattr(e, "idx", None))
                     for e in path)
        want[keys] = (tuple(leaf.shape), str(leaf.dtype))
    paths, leaves = tree_flatten_with_keys(cache)
    for path, leaf in zip(paths, leaves):
        jpath, stacked = jax_place(cfg_j, path)
        jshape, jdt = want[jpath]
        assert (tuple(leaf.shape), _dt(leaf)) == \
            (jshape[1:] if stacked else jshape, jdt), path


@pytest.mark.parametrize("arch", [a for a in ARCHS if not sp.cell_spec(
    configs.get_config(a), "long_500k").runnable])
def test_long_500k_full_attention_skips(arch):
    """A full-attention arch's ``long_500k`` cell is ``SKIP`` with JAX's
    reason; nothing is traced."""
    r = dryrun.run_cell(arch, "long_500k")
    jspec = jsp.cell_spec(jconfigs.get_config(arch), "long_500k")
    assert r["status"] == "SKIP"
    assert r["skip_reason"] == jspec.skip_reason


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cell_ok(arch, shape):
    """The smoke config's prefill and decode at batch 8 × 64 on the fake
    (2, 2, 2) mesh: ``OK``, with work, bytes and collectives counted."""
    r = dryrun.run_cell(arch, shape, cfg=configs.get_smoke_config(arch),
                        mesh_shape=POD[0], mesh_names=POD[1], batch=8,
                        seq_len=64)
    assert r["status"] == "OK", r.get("trace")
    assert r["cost_analysis"]["flops"] > 0
    assert r["memory"]["argument_bytes"] > 0
    assert r["collectives"]
    assert r["roofline"]["step_time_bound_s"] > 0


def test_argument_bytes_are_local_shards():
    """A rank's argument bytes (prefill: parameters and batch) equal the
    sum over leaves of the local shard each placement leaves it: every
    ``Shard`` dim divided by its mesh extent."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed.sharding import make_rules, placements_of
    from repro_torch.launch import shardings as sh

    arch = "qwen2-0.5b"
    cfg = configs.get_smoke_config(arch)
    r = dryrun.run_cell(arch, "prefill_32k", cfg=cfg, mesh_shape=POD[0],
                        mesh_names=POD[1], batch=8, seq_len=64)
    with dryrun.fake_mesh(*POD, device_type="cpu") as mesh, \
            FakeTensorMode():
        rules = make_rules(mesh, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
        spec = dataclasses.replace(sp.cell_spec(cfg, "prefill_32k"),
                                   batch=8, seq_len=64)
        want = 0
        for tree, axes in ((build(cfg, "cpu").init(0), sh.param_axes),
                           (sp.batch_specs(cfg, spec, "cpu"),
                            sh.batch_axes)):
            paths, leaves = tree_flatten_with_keys(tree)
            for p, leaf in zip(paths, leaves):
                shape = list(leaf.shape)
                pl = placements_of(rules, sh.leaf_spec(
                    rules, axes(p, leaf), tuple(shape)))
                for i, q in enumerate(pl):
                    if q.is_shard():
                        shape[q.dim] //= mesh.size(i)
                n = 1
                for s in shape:
                    n *= s
                want += n * leaf.element_size()
    assert r["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("k", [1, 8])
def test_dryrun_pim_cadence(k):
    """logreg on the (16, 16) mesh (lanes over ``data``, 16 a rank): the
    merge's one collective a round, over the 16 ranks of ``data``, behind
    ``k`` local steps of 3 kernels (the forward and gradient products and
    the LUT sigmoid); a plain round has no kernel after its collective."""
    r = dryrun_pim.build(False, merge_every=k, chunk=2)
    assert r["status"] == "OK" and r["lanes_over"] == ["data"]
    assert r["collectives_per_round"]["all-gather"]["count"] == 1
    assert r["merge_overlap"]["dots"] == 3 * k
    assert not r["merge_overlap"]["overlapped"]
    assert r["roofline"]["collective_s"] > 0


@pytest.mark.parametrize("workload", ["svm", "multinomial"])
def test_dryrun_pim_other_workloads(workload):
    """svm and multinomial trace through ``Workload.spec_fns`` (their
    ``spec_consts``): ``OK``, the merge's one collective a round."""
    r = dryrun_pim.build(False, workload=workload, chunk=2)
    assert r["status"] == "OK"
    assert sum(c["count"] for c in r["collectives_per_round"].values()) == 1


def test_spec_fns_refused_without_spec_consts():
    """A workload with no spec-level constants (K-means) has no
    ``spec_fns``."""
    from repro_torch.core import mlalgos as ml
    with pytest.raises(NotImplementedError, match="kmeans"):
        ml.KMeans(k=4).spec_fns(features=8, rows=64)


def test_dryrun_pim_overlap_is_checked():
    """Under the double-buffered pipeline the slow hop's collective comes
    before this round's kernels (``overlapped``)."""
    r = dryrun_pim.build(False, overlap=True, chunk=2)
    assert r["merge_overlap"]["overlapped"]
    assert r["merge_overlap"]["dots_after_first_collective"] == 3


# -- the kernel wrappers' fake paths ----------------------------------------

def _fake_and_real(make):
    """``make(device)`` under ``FakeTensorMode`` and on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = make()
    return fake, make()


def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype)

    def ints(lo, hi, *shape, dtype=torch.int32):
        return torch.randint(lo, hi, shape, generator=g).to(dtype)

    q, k, v = rnd(2, 4, 16, 32), rnd(2, 2, 16, 32), rnd(2, 2, 16, 32)
    o, lse = ref.flash_attention_ref(q, k, v, causal=True, return_lse=True)
    return {
        "flash_attention": (
            lambda t: fa.flash_attention(*t, causal=True, return_lse=True),
            lambda t: ref.flash_attention_ref(*t, causal=True,
                                              return_lse=True),
            (q, k, v), fa.flash_attention,
            (analysis.nbytes(q, k, v, o, lse),
             4 * 32 * 2 * 4 * (16 * 17 // 2), "fp32")),
        "flash_attention_bwd": (
            lambda t: fa.flash_attention_bwd(*t, causal=True),
            lambda t: ref.flash_attention_bwd_ref(*t, causal=True),
            (q, k, v, o, rnd(2, 4, 16, 32), lse), fa.flash_attention_bwd,
            (analysis.nbytes(q, k, v, o, o, lse, q, k, v),
             10 * 32 * 2 * 4 * (16 * 17 // 2), "fp32")),
        "fxp_matmul": (
            lambda t: fxp.fxp_matmul(*t), lambda t: ref.fxp_matmul_ref(*t),
            (ints(-128, 127, 3, 64, 100, dtype=torch.int8),
             ints(-128, 127, 100, 5, dtype=torch.int8)), fxp.fxp_matmul,
            (3 * 64 * 100 + 100 * 5 + 4 * 3 * 64 * 5,
             2 * 3 * 64 * 100 * 5, "int8")),
        "lut_activation": (
            lambda t: lut.lut_activation(*t, x_min=-8.0, x_max=8.0),
            lambda t: ref.lut_activation_ref(*t, -8.0, 8.0),
            (rnd(7, 33), rnd(1024)), lut.lut_activation,
            (2 * 4 * 7 * 33 + 4 * 1024, 4 * 7 * 33, "fp32")),
        "kmeans_assign": (
            lambda t: km.kmeans_assign(*t), lambda t: ref.kmeans_assign_ref(
                *t), (rnd(2, 50, 6), rnd(3, 6), torch.ones(2, 50)),
            km.kmeans_assign,
            (4 * (2 * 50 * 6 + 3 * 6 + 2 * 50 + 2 * 3 * 6 + 2 * 3 + 2),
             2 * 50 * (2 * 3 * 6 + 2 * 3 + 5 * 6 + 2), "fp32")),
        "split_hist": (
            lambda t: shist.split_hist(*t, n_nodes=2, n_bins=4, n_classes=3),
            lambda t: ref.split_hist_ref(*t, n_nodes=2, n_bins=4,
                                         n_classes=3),
            (ints(0, 2, 2, 40), ints(0, 4, 2, 40, 5, dtype=torch.uint8),
             ints(0, 3, 2, 40), torch.ones(2, 40)), shist.split_hist,
            (4 * 2 * 40 + 2 * 40 * 5 + 4 * 2 * 40 + 4 * 2 * 40
             + 4 * 2 * 2 * 5 * 4 * 3, 0, "fp32")),
    }


KERNELS = ("flash_attention", "flash_attention_bwd", "fxp_matmul",
           "lut_activation", "kmeans_assign", "split_hist")


@pytest.mark.parametrize("name", KERNELS)
def test_fake_path_shapes_and_charge(name):
    """Fake inputs: the plain version's shapes and dtypes, one charge of
    the launch's bytes and operations, no launch counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    call, plain, args, wrapper, (n_bytes, ops, kind) = _kernel_cases()[name]
    want = plain(args)
    launches = wrapper.launches
    with FakeTensorMode() as mode:
        fake_args = tuple(mode.from_tensor(a) for a in args)
        with analysis.RankCounter() as rc:
            got = call(fake_args)
    assert wrapper.launches == launches
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert rc.count.bytes == n_bytes
    assert rc.count.ops.get(kind, 0.0) == ops


@pytest.mark.parametrize("missing", [False, True])
def test_rank_counter_wraps_the_sharding_propagator(monkeypatch, missing):
    """``RankCounter`` wraps at least one of DTensor's propagator methods
    while active and restores them after; with none of their names on
    the propagator it refuses to count (else DTensor's global-shape ops
    would be counted as a rank's own)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def methods():
        return {n: ShardingPropagator.__dict__.get(n)
                for n in analysis._PROPAGATORS}

    if missing:
        monkeypatch.setattr(analysis, "_PROPAGATORS", ("_no_such_method",))
        with pytest.raises(RuntimeError, match="_no_such_method"):
            analysis.RankCounter().__enter__()
        assert not analysis._ACTIVE
        return
    before = methods()
    assert any(m is not None for m in before.values())
    with analysis.RankCounter():
        during = methods()
        assert any(during[n] is not before[n]
                   for n in before if before[n] is not None)
    assert methods() == before


@pytest.mark.parametrize("name", KERNELS)
def test_cpu_tensor_runs_the_plain_version(name):
    """A real CPU tensor is not traced: the wrapper returns the plain
    version's values."""
    call, plain, args, _, _ = _kernel_cases()[name]
    assert not kbuild.traced(*args)
    got, want = call(args), plain(args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dtensor_never_reaches_a_wrapper():
    """A ``DTensor`` is refused by the wrappers (``kernels.dispatch``
    maps each rank's shard instead)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    with dryrun.fake_mesh((2,), ("model",), device_type="cpu") as mesh:
        x = distribute_tensor(torch.zeros(4, 8), mesh, (Replicate(),))
        with pytest.raises(TypeError, match="local tensors"):
            lut.lut_activation(x, torch.zeros(16), x_min=-1.0, x_max=1.0)
