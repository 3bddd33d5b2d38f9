"""Port parity of the compressed merge's components and the overlap
combinator: ``repro_torch.core.quantize`` (``QFormat``, ``ef_quantize``,
``quantize_dequantize``, ``topk_keep``), ``repro_torch.distributed.
compression`` and ``repro_torch.distributed.overlap`` against the JAX
package's eager calls on the same numpy inputs.

The components are bit-equal except the sign of a zero: values are
compared with ``assert_array_equal`` (−0.0 == +0.0) and dtypes, where
``tests/test_mesh_collectives_prop.py`` shows JAX's own two paths
disagreeing on it.  JAX's ``quantize_dequantize`` is jitted, and under
``jit`` XLA divides the absmax by ``qmax`` as a multiply by its
reciprocal, so the port is held bit-equal to the eager round trip and
within one quantum of the jitted one.
"""

import dataclasses
import doctest

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import quantize as jqz  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro.distributed import overlap as joverlap  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import overlap  # noqa: E402
from repro_torch.distributed.compression import CompressionConfig  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from torch_parity import (assert_bits_equal, rng,  # noqa: E402
                          single_process_world, to_numpy, to_torch)


def _same(port, ref) -> None:
    """Equal values and dtype; −0.0 and +0.0 count as equal."""
    a, b = to_numpy(port), np.asarray(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_tree(port, ref) -> None:
    ours = tree_leaves(port)
    theirs = jax.tree.leaves(ref)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        _same(a, b)


def _ties(bits: int, n: int = 300, seed: int = 0) -> np.ndarray:
    """Half-integers and an entry at qmax: the scale is exactly 1.0, so
    ``x / scale`` sits on rounding ties."""
    qmax = 2 ** (bits - 1) - 1
    r = rng(seed)
    x = (r.integers(-qmax, qmax, n) + 0.5).astype(np.float32)
    x[0] = qmax
    return x


# -- core.quantize -----------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("case", ["random", "ties", "zero"])
def test_ef_quantize_matches_jax(bits, case):
    r = rng(bits)
    if case == "random":
        g = (r.standard_normal((37, 5)) * 3).astype(np.float32)
        e = (r.standard_normal((37, 5)) * 0.01).astype(np.float32)
    elif case == "ties":
        g, e = _ties(bits), np.zeros(300, np.float32)
    else:                        # g + e = 0 exactly: the 1e-12 floor
        g = r.standard_normal(40).astype(np.float32)
        e = -g
    q, ne = jqz.ef_quantize(jnp.asarray(g), jnp.asarray(e), bits=bits)
    pq, pne = qz.ef_quantize(to_torch(g), to_torch(e), bits=bits)
    assert_bits_equal(pq.values, q.values)
    assert_bits_equal(pq.scale, q.scale)
    _same(pne, ne)


@pytest.mark.parametrize("bits", [2, 8, 12])
def test_quantize_dequantize_matches_eager_jax(bits):
    """Bit-equal to the eager round trip; within one quantum of the
    jitted ``repro.core.quantize.quantize_dequantize``."""
    for seed in range(8):
        r = rng(seed)
        x = (r.standard_normal(129) * r.uniform(0.01, 100)).astype(np.float32)
        eager = jqz.quantize_symmetric(jnp.asarray(x), bits=bits)
        got = qz.quantize_dequantize(to_torch(x), bits)
        _same(got, eager.dequantize(jnp.float32))
        jitted = np.asarray(jqz.quantize_dequantize(jnp.asarray(x), bits))
        assert np.abs(to_numpy(got) - jitted).max() <= float(eager.scale)
    _same(qz.quantize_dequantize(to_torch(_ties(bits)), bits),
          jqz.quantize_symmetric(jnp.asarray(_ties(bits)),
                                 bits=bits).dequantize(jnp.float32))


@pytest.mark.parametrize("case", ["ties", "all-zero", "distinct"])
@pytest.mark.parametrize("frac", [0.01, 0.25, 0.3, 1.0])
def test_topk_keep_matches_jax(case, frac):
    """Exactly ``max(1, floor(size·frac))`` survivors, the lower index
    first among equal magnitudes, as ``lax.top_k`` picks them."""
    r = rng(3)
    if case == "ties":           # magnitudes 1 and 2, signs mixed
        x = (r.choice([-2.0, -1.0, 1.0, 2.0], (6, 7))).astype(np.float32)
    elif case == "all-zero":
        x = np.zeros((6, 7), np.float32)
    else:
        x = r.standard_normal((6, 7)).astype(np.float32)
    k = max(1, int(x.size * frac))
    got = qz.topk_keep(to_torch(x), frac)
    assert_bits_equal(got, jqz.topk_keep(jnp.asarray(x), frac))
    if case != "all-zero":
        assert int((got != 0).sum()) == k
    _, idx = jax.lax.top_k(jnp.abs(jnp.asarray(x).reshape(-1)), k)
    assert qz.topk_indices(to_torch(x), frac).tolist() == \
        np.asarray(idx).tolist()


def test_topk_sparsify_matches_jax():
    r = rng(4)
    g = r.standard_normal(100).astype(np.float32)
    e = (r.standard_normal(100) * 0.3).astype(np.float32)
    kept, resid = jcomp.topk_sparsify(jnp.asarray(g), 0.1, jnp.asarray(e))
    pk, pr = comp.topk_sparsify(to_torch(g), 0.1, to_torch(e))
    assert_bits_equal(pk, kept)
    _same(pr, resid)


@pytest.mark.parametrize("total_bits,int_bits", [(8, 1), (16, 1), (16, 7),
                                                 (32, 15)])
def test_qformat_round_trips_match_jax(total_bits, int_bits):
    """Saturating casts, the float round trip and the wide-accumulate
    add and multiply, bit for bit; values run past both saturation
    bounds."""
    frac = total_bits - 1 - int_bits
    jf = jqz.QFormat(int_bits=int_bits, frac_bits=frac)
    pf = qz.QFormat(int_bits=int_bits, frac_bits=frac)
    assert (pf.total_bits, pf.scale, pf.max_value, pf.min_value) == \
        (jf.total_bits, jf.scale, jf.max_value, jf.min_value)
    assert str(pf.dtype).split(".")[-1] == jnp.dtype(jf.dtype).name
    r = rng(total_bits + int_bits)
    x = (r.standard_normal(200) * pf.max_value).astype(np.float32)
    x[:4] = [pf.max_value * 3, pf.min_value * 3, pf.max_value,
             pf.min_value]
    q, pq = jf.quantize(jnp.asarray(x)), pf.quantize(to_torch(x))
    assert_bits_equal(pq, q)
    assert_bits_equal(pf.dequantize(pq), jf.dequantize(q))
    if total_bits <= 16:          # int32 products of 32-bit operands wrap
        b = np.asarray(q)[::-1].copy()
        assert_bits_equal(pf.add(pq, to_torch(b)), jf.add(q, jnp.asarray(b)))
        assert_bits_equal(pf.mul(pq, to_torch(b)), jf.mul(q, jnp.asarray(b)))
    with pytest.raises(ValueError, match="total bits"):
        qz.QFormat(int_bits=3, frac_bits=3)


# -- distributed.compression -----------------------------------------------


CONFIGS = {
    "int8": dict(bits=8),
    "int4": dict(bits=4),
    "int8-no-ef": dict(bits=8, error_feedback=False),
    "top-k-int8": dict(bits=8, top_k_frac=0.25),
    "top-k-raw": dict(bits=None, top_k_frac=0.5),
    "top-k-no-ef": dict(bits=8, top_k_frac=0.25, error_feedback=False),
}


def _tree(seed: int):
    r = rng(seed)
    return {"counts": r.integers(0, 50, 6).astype(np.int32),
            "sums": (r.standard_normal((3, 4)) * 5).astype(np.float32),
            "loss": np.float32(r.uniform(1, 2))}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_ef_compress_tree_matches_jax(name):
    """Three rounds, the error carried: integer leaves cross untouched,
    float leaves and residuals equal JAX's."""
    jcfg = jcomp.CompressionConfig(**CONFIGS[name])
    cfg = CompressionConfig(**CONFIGS[name])
    err = comp.init_error_state(tree_map(to_torch, _tree(0)))
    jerr = jcomp.init_error_state(jax.tree.map(jnp.asarray, _tree(0)))
    _same_tree(err, jerr)
    for seed in range(3):
        tree = _tree(seed)
        jout, jerr = jcomp.ef_compress_tree(
            jax.tree.map(jnp.asarray, tree), jerr, jcfg)
        out, err = comp.ef_compress_tree(tree_map(to_torch, tree), err, cfg)
        _same_tree(out, jout)
        _same_tree(err, jerr)
        assert_bits_equal(out["counts"], tree["counts"])
    assert comp.wire_bytes(out, cfg) == jcomp.wire_bytes(jout, jcfg)


def test_wire_bytes_and_ladder_match_jax():
    trees = [{"g": np.zeros(64, np.float32), "loss": np.float32(0)},
             np.zeros(64, np.float32),
             {"hist": np.zeros((10, 3), np.int32),
              "g": np.zeros(100, np.float32)},
             (np.zeros((5, 4), np.float32), np.float32(0))]
    cfgs = [None] + [dict(v) for v in CONFIGS.values()] + [
        dict(bits=16), dict(bits=12, top_k_frac=0.01)]
    for tree in trees:
        for c in cfgs:
            theirs = jcomp.wire_bytes(
                jax.tree.map(jnp.asarray, tree),
                None if c is None else jcomp.CompressionConfig(**c))
            ours = comp.wire_bytes(
                tree_map(to_torch, tree),
                None if c is None else CompressionConfig(**c))
            assert ours == theirs, (tree, c)
    assert comp.wire_bytes(tree_map(to_torch, trees[0]),
                           CompressionConfig(bits=8)) == 73
    for base, bits, rungs in ((0.25, 8, 3), (1.0, None, 1), (0.5, 4, 0)):
        ours = comp.top_k_ladder(base, bits=bits, rungs=rungs)
        theirs = jcomp.top_k_ladder(base, bits=bits, rungs=rungs)
        assert [dataclasses.asdict(c) for c in ours] == \
            [dataclasses.asdict(c) for c in theirs]
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="base_frac"):
            comp.top_k_ladder(bad)


@pytest.mark.parametrize("kw", [
    dict(bits=0), dict(bits=1), dict(bits=17), dict(bits=-8),
    dict(bits=None), dict(top_k_frac=0.0), dict(top_k_frac=1.5),
    dict(bits=None, top_k_frac=0.0), dict(bits=2), dict(bits=16),
    dict(bits=None, top_k_frac=1.0), dict(error_feedback=False),
    dict(slow_axis=None, fast_axes=()),
])
def test_config_validation_matches_jax(kw):
    try:
        theirs = jcomp.CompressionConfig(**kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[0]):
            CompressionConfig(**kw)
        return
    assert dataclasses.asdict(CompressionConfig(**kw)) == \
        dataclasses.asdict(theirs)


def test_leaf_policy_and_the_mesh_reduction():
    assert comp._compressible(torch.zeros(2))
    assert comp._compressible(torch.zeros(2, dtype=torch.bfloat16))
    assert comp._compressible(1.5)
    assert not comp._compressible(torch.zeros(2, dtype=torch.int32))
    assert not comp._compressible(3)
    # the mesh reduction at one participant is the emulation, integer
    # leaves exact (ROADMAP item 11; ``test_torch_collectives.py`` holds
    # it against JAX's at hop 2 and 4)
    from repro_torch.launch.mesh import make_pim_mesh

    g = torch.tensor([0.5, -1.25, 3.0, 0.0])
    tree = {"g": g, "n": torch.tensor([3, 4], dtype=torch.int32)}
    err = comp.init_error_state(tree)
    with single_process_world():
        got, new = comp.compressed_reduce(tree, err, CompressionConfig(),
                                          mesh=make_pim_mesh(1, 1))
    want, want_new = comp.ef_compress_tree(tree, err, CompressionConfig())
    for a, b in zip(tree_leaves((got, new)), tree_leaves((want, want_new))):
        assert torch.equal(a, b)


def test_doc_examples():
    failed, tried = doctest.testmod(comp, verbose=False)
    assert tried > 0 and failed == 0


# -- distributed.overlap ---------------------------------------------------


def test_double_buffered_body_matches_jax():
    """Three rounds of a toy pipeline: the merge reads the pending
    buffer, the compute the state; carries and metrics equal JAX's, and
    the merge is issued before the compute."""
    calls = []

    def pieces(xp, log):
        def merge_fn(p, e):
            log.append("merge")
            return p * 2.0, e + 1.0

        def compute_fn(st):
            log.append("compute")
            return st * 0.5 + 1.0, None

        def commit_fn(st, m, mom):
            return st + m, mom * 0.9 + m, {"m": xp.sum(m)}

        return merge_fn, compute_fn, commit_fn

    jbody = joverlap.double_buffered_body(*pieces(jnp, []))
    body = overlap.double_buffered_body(*pieces(torch, calls))
    x = rng(5).standard_normal(4).astype(np.float32)
    jcarry = (jnp.asarray(x), jnp.asarray(x[::-1].copy()), jnp.float32(0),
              jnp.zeros(4))
    carry = (to_torch(x), to_torch(x[::-1].copy()), torch.tensor(0.0),
             torch.zeros(4))
    for _ in range(3):
        jcarry, jm = jbody(jcarry, None)
        carry, m = body(carry)
        _same_tree(carry, jcarry)
        _same(m["m"], jm["m"])
    assert calls == ["merge", "compute"] * 3


@pytest.mark.parametrize("reduce", [False, True])
def test_microbatched_grads_match_jax(reduce):
    """A least-squares loss over 4 microbatches: mean loss and mean
    gradients within rtol 1e-6 (float32, the gradient's summation order
    differs), with and without a per-microbatch reduction."""
    r = rng(6)
    params = {"w": r.standard_normal(5).astype(np.float32),
              "b": np.float32(0.3)}
    batch = {"x": r.standard_normal((16, 5)).astype(np.float32),
             "y": r.standard_normal(16).astype(np.float32)}

    def loss(xp):
        def fn(p, b):
            z = b["x"] @ p["w"] + p["b"] - b["y"]
            return xp.mean(z * z), {}
        return fn

    jreduce = (lambda g: jax.tree.map(lambda t: t * 0.5, g)) if reduce \
        else None
    preduce = (lambda g: tree_map(lambda t: t * 0.5, g)) if reduce else None
    jl, jg, _ = joverlap.microbatched_grads(
        loss(jnp), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, batch), n_micro=4, reduce_fn=jreduce)
    pl, pg, aux = overlap.microbatched_grads(
        loss(torch), tree_map(to_torch, params), tree_map(to_torch, batch),
        n_micro=4, reduce_fn=preduce)
    assert aux is None and pl.dtype == torch.float32
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    for key in params:
        np.testing.assert_allclose(to_numpy(pg[key]), np.asarray(jg[key]),
                                   rtol=1e-6, atol=1e-7)
