"""Port parity of the collectives (``repro_torch.distributed.collectives``
and ``compression.compressed_reduce``) against the JAX package's.

JAX's collectives run in this process under ``jax.vmap(...,
axis_name=...)``, one participant a vmapped slice; the port's run in a
world of 4 gloo ranks on the CPU (``torch_mesh_ref.run_world``): at hop
2 on a (2, 2) mesh and at hop 4 on a (4, 1) mesh, the slow-hop
collectives over ``pod`` and the hierarchical ones over both axes.
Every output and residual must equal JAX's bit for bit in float32,
bfloat16 and float16, except the sign of a zero (ROADMAP queue C: where
``x + e`` is −0.0 the two packages may disagree on the zero's sign).

At hop 1 (one process, a ``(1, 1)`` mesh) each collective is the
single-device emulation, ``quantize.ef_quantize`` and
``compression.ef_compress_tree``, bit for bit up to the sign of a zero
(the emulation adds a zero error where the collective sends ``x``
itself, and takes its residual in two steps where the collective takes
it in one).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed import compression as jcomp  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.distributed import collectives as coll  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig)
from torch_mesh_ref import (DTYPES, HOPS, MESHWIDE, SINGLE,  # noqa: E402
                            collective_inputs, run_world)
from torch_parity import single_process_world  # noqa: E402

CASES = [(name, hop, d) for name in (*SINGLE, *MESHWIDE) for hop in HOPS
         for d in DTYPES]


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    """Every rank's outputs of every case, from one world of 4 ranks."""
    ranks = run_world("collectives_scenario", 4,
                      str(tmp_path_factory.mktemp("collectives_world")),
                      timeout=240.0)
    return ranks


def assert_equal_but_zero_sign(got, want, what=""):
    got = np.asarray(got, np.float32) if got.dtype != np.int32 else got
    want = np.asarray(want, got.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype == np.int32:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    same = (got.view(np.uint32) == want.view(np.uint32)) | \
        ((got == 0) & (want == 0))
    assert same.all(), (what, int((~same).sum()), got[~same][:5],
                        want[~same][:5])


def _jdtype(name):
    return getattr(jnp, name)


def _jax_single(name, hop, dname, d):
    """JAX's outputs of a slow-hop case for the participants of data
    index ``d``: a list of (hop, ...) arrays."""
    fn, kw = SINGLE[name]
    kw = dict(kw)
    inp = collective_inputs(hop)
    x = jnp.asarray(inp["x"][:, d]).astype(_jdtype(dname))
    e = jnp.asarray(inp["e"][:, d]).astype(_jdtype(dname))
    f = getattr(jcoll, fn)
    if kw.pop("alive", False):
        alive = jnp.asarray(inp["alive"])
        out = jax.vmap(lambda x, e, a: f(x, e, "pod", alive=a, **kw),
                       axis_name="pod")(x, e, alive)
    elif fn == "quantized_psum":
        out = jax.vmap(partial(f, axis="pod", **kw), axis_name="pod")(x)
    else:
        out = jax.vmap(lambda x, e: f(x, e, "pod", **kw),
                       axis_name="pod")(x, e)
    return list(out) if isinstance(out, tuple) else [out]


def _jax_meshwide(name, hop, dname):
    """JAX's outputs of a case over both axes: (hop, data, ...) arrays."""
    inp = collective_inputs(hop)
    x = jnp.asarray(inp["x"]).astype(_jdtype(dname))
    e = jnp.asarray(inp["e"]).astype(_jdtype(dname))
    n = jnp.asarray(inp["counts"])

    def both(f):
        return jax.vmap(jax.vmap(f, axis_name="data"), axis_name="pod")

    if name == "hierarchical_psum":
        out = both(lambda x, n: jcoll.hierarchical_psum(
            {"g": x, "n": n}, ("data",), "pod"))(x, n)
        return [out["g"], out["n"]]
    if name.startswith("grad_reduce"):
        bits = 8 if name.endswith("int8") else 0
        out = both(lambda x: jcoll.hierarchical_grad_reduce(
            {"g": x}, fast_axes=("data",), slow_axis="pod",
            compress_bits=bits))(x)
        return [out["g"]]
    cfg = {"compressed_reduce_int8": jcomp.CompressionConfig(bits=8),
           "compressed_reduce_int8_noef": jcomp.CompressionConfig(
               bits=8, error_feedback=False),
           "compressed_reduce_topk": jcomp.CompressionConfig(
               bits=8, top_k_frac=0.25)}[name]
    red, new = both(lambda x, e, n: jcomp.compressed_reduce(
        {"g": x, "n": n}, {"g": e, "n": jnp.zeros_like(n)}, cfg))(x, e, n)
    return [red["g"], red["n"], new["g"], new["n"]]


def _np(a):
    a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
    return a


@pytest.mark.parametrize("name,hop,dtype", CASES)
def test_port_collective_equals_jax_under_vmap(port_results, name, hop,
                                               dtype):
    """Every rank's outputs of the case equal JAX's for its participant,
    bit for bit up to the sign of a zero."""
    want_by_d = {}
    for rank, res in enumerate(port_results):
        p, d, got = res[(name, hop, dtype)]
        if name in SINGLE:
            if d not in want_by_d:
                want_by_d[d] = _jax_single(name, hop, dtype, d)
            want = [w[p] for w in want_by_d[d]]
        else:
            if not want_by_d:
                want_by_d[0] = _jax_meshwide(name, hop, dtype)
            want = [w[p, d] for w in want_by_d[0]]
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_equal_but_zero_sign(g, _np(w),
                                       f"{name} rank {rank} output {i}")


def test_every_rank_of_a_pod_gets_the_same_reduction(port_results):
    """The replicas agree: ranks of one (pod, data) coordinate class see
    the same reduced value of every slow-hop case."""
    for key in port_results[0]:
        name, hop, dtype = key
        if name not in SINGLE:
            continue
        outs = {}
        for res in port_results:
            p, d, got = res[key]
            ref = outs.setdefault(d, got[0])
            np.testing.assert_array_equal(got[0], ref)


# -- hop 1: the single-device emulation ------------------------------------


@pytest.fixture(scope="module")
def pod1():
    """The ``pod`` group of a (1, 1) mesh in this process."""
    from repro_torch.launch.mesh import make_pim_mesh

    with single_process_world():
        yield make_pim_mesh(1, 1)


def _hop1_inputs(dtype):
    inp = collective_inputs(2)
    dt = getattr(torch, dtype)
    return (torch.from_numpy(inp["x"][0, 0]).to(dt),
            torch.from_numpy(inp["e"][0, 0]).to(dt))


HOP1 = ("quantized_psum", "quantized_psum_ef", "sparse_int8_ef",
        "sparse_int8_noef", "sparse_raw_ef", "sparse_raw_noef",
        "compressed_reduce_int8", "compressed_reduce_topk")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", HOP1)
def test_hop1_collective_is_the_emulation(pod1, name, dtype):
    x, e = _hop1_inputs(dtype)
    group = pod1.get_group("pod")
    if name == "quantized_psum":
        got, want = [coll.quantized_psum(x, group)], \
            [qz.quantize_dequantize(x, 8)]
    elif name == "quantized_psum_ef":
        q, ne = qz.ef_quantize(x, e, bits=8)
        got = list(coll.quantized_psum_ef(x, e, group))
        want = [q.dequantize(x.dtype), ne]
    elif name.startswith("sparse"):
        kw = SINGLE[name][1]
        cfg = CompressionConfig(bits=kw["bits"], top_k_frac=kw["frac"],
                                error_feedback=kw.get("error_feedback",
                                                      True))
        got = list(coll.sparse_psum_ef(x, e, group, **kw))
        red, new = comp.ef_compress_tree({"g": x}, {"g": e}, cfg)
        want = [red["g"], new["g"]]
    else:
        cfg = (CompressionConfig(bits=8) if name.endswith("int8")
               else CompressionConfig(bits=8, top_k_frac=0.25))
        red, new = comp.compressed_reduce({"g": x}, {"g": e}, cfg,
                                          mesh=pod1)
        ered, enew = comp.ef_compress_tree({"g": x}, {"g": e}, cfg)
        got, want = [red["g"], new["g"]], [ered["g"], enew["g"]]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert_equal_but_zero_sign(g.float().numpy(), w.float().numpy(),
                                   name)


def test_psum_sums_in_rank_order_and_integers_exactly(pod1):
    """At one participant a sum is the value itself, bits and zero signs
    kept; an integer tree crosses exactly."""
    group = pod1.get_group("pod")
    x = torch.tensor([-0.0, 1.5, -2.25])
    got = coll.psum(x, group)
    assert torch.equal(got.view(torch.int32), x.view(torch.int32))
    tree = {"a": x, "b": torch.tensor([3, -4], dtype=torch.int32),
            "c": (x[:2].double(),)}
    out = coll.psum_tree(tree, group)
    assert out.keys() == tree.keys() and isinstance(out["c"], tuple)
    assert torch.equal(out["b"], tree["b"])
    assert out["c"][0].dtype == torch.float64
