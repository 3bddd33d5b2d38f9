"""The port's mesh engine (``repro_torch.core.make_mesh_grid``) against
the JAX package's mesh and against the port's own single-device grid.

The port runs on a (2, 2) ``("pod", "data")`` mesh of 4 gloo ranks on
the CPU (``torch_mesh_ref.mesh_scenario``, one world for the module);
the JAX package runs the same cells in a subprocess on a (2, 2) mesh of
4 forced CPU devices (``torch_mesh_ref.jax_mesh_main``), under
``use_kernels(False)``; both start together.  Inputs are numpy arrays
from fixed seeds.  What is held, with ``test_mesh_engine.py``'s cells:

* plan cells (``make_linreg_step`` at 192 × 6, 16 vDPUs, 16 steps)
  against JAX's mesh: exact cells within 1e-5·max|w|, compressed cells
  within 1e-4·max|w| (the port's bar for compressed trajectories,
  ``test_torch_overlap.py``), losses at rtol 1e-4.  Top-k is held here,
  against JAX's mesh: each pod keeps its own top entries, and JAX's own
  bars against its emulation fail at hop 2 (ROADMAP queue C);
* the scan and python engines bit for bit on the mesh, every cell;
* against the port's ``mesh=None`` grid, with JAX's bars: exact cells
  at atol 1e-6, the int8 cells within their exact cell's EF oracle;
* every rank's results bit-equal (the replicas);
* the workloads through ``api.fit`` against JAX's mesh and the port's
  grid (evals at rtol 1e-5, atol 1e-6); the tree bit for bit against
  the port's grid (JAX's tree cannot run on a mesh here, ROADMAP queue
  C); K-means with queue C's tolerance;
* integer leaves, the EF buffer's hop layout, split fits, a JAX mesh
  buffer resumed, the controller and the cost model's chip count.
"""

import functools
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_cpu_grid, make_mesh_grid  # noqa: E402
from repro_torch.core import mlalgos as ml  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import merge_plan as mp  # noqa: E402
from repro_torch.launch.mesh import make_pim_mesh  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.tuning.cost import CostModel  # noqa: E402
import torch_mesh_ref as ref  # noqa: E402
from torch_parity import single_process_world  # noqa: E402

# the EF oracle's bars (test_mesh_engine.py's ORACLE_TOL); top-k is not
# among them: see the module docstring
ORACLE_TOL = 0.05
ORACLE_CELLS = {c: e for c, e in ref.EF_ORACLE.items() if c != "topk_k4"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, JAX's results): the port's world and the
    JAX subprocess started together.  JAX's results hold its EF resume
    pair under ``"resume"``."""
    tmp = tmp_path_factory.mktemp("mesh")
    jax_out = str(tmp / "jax.pkl")
    with ThreadPoolExecutor(1) as pool:
        jax = pool.submit(ref.run_jax, "jax_mesh_main", jax_out, devices=4,
                          timeout=300.0)
        ranks = ref.run_world("mesh_scenario", 4, str(tmp / "world"),
                              args=(jax_out + ".resume",), timeout=300.0)
        jax = jax.result(timeout=300.0)
    with open(jax_out + ".resume", "rb") as f:
        jax["resume"] = pickle.load(f)
    return ranks, jax


@functools.lru_cache(maxsize=None)
def grid_cell(cell):
    """The cell on the port's single-device grid, in this process."""
    grid = make_cpu_grid(ref.N_VDPUS)
    X, y = ref.linreg_data()
    data, n, lf, uf, w0 = ml.make_linreg_step(grid, X, y, lr=0.05)
    return ref._fit_np(grid, lf, uf, w0, data, ref.STEPS,
                       ref.plan_of(mp, comp, cell), scan_chunk=4)


@functools.lru_cache(maxsize=None)
def grid_workload(name):
    wl, X, y, c0 = ref.workload_case(ml, name)
    res = ref.fit_workload(ml, wl, make_cpu_grid(ref.N_VDPUS), X, y, c0)
    state = res.state if name != "dtree" else (
        res.state.feature, res.state.threshold, res.state.leaf_value,
        res.state.bin_edges)
    return ([a.numpy() for a in tree_leaves(state)],
            {k: float(v) for k, v in res.eval(X, y).items()})


def near(got, want, bar):
    """``got`` within ``bar``·max|want| of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=bar * float(np.abs(want).max()))


# -- the layout --------------------------------------------------------------


def test_ranks_sit_pod_major(runs):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        assert (res["pod"], res["data"]) == divmod(r, 2)
        assert res["n_shards"] == 4 and res["n_local"] == 4
        assert res["hop"] == 2


def test_vdpus_must_divide_shards(runs):
    ranks, _ = runs
    for res in ranks:
        assert "not divisible by data shards 4" in res["indivisible"]


def test_pods_must_divide_the_world():
    with single_process_world():
        with pytest.raises(ValueError, match="divide"):
            make_pim_mesh(2)


def test_make_mesh_grid_in_one_process_reduces():
    """A single process builds a (1, 1) mesh through ``init_world``."""
    with single_process_world():
        grid = make_mesh_grid(8, device="cpu")
        assert grid.data_axes == ("pod", "data")
        assert tuple(grid.mesh.shape) == (1, 1)
        assert mp.hop_size(grid) == 1
        data, _ = grid.shard_rows(torch.arange(16.0)[:, None])
        out = grid.map_reduce(
            lambda _, sl: {"s": (sl["X"][..., 0] * sl["w"]).sum(-1)},
            None, data)
        assert float(out["s"]) == 120.0


def test_a_cpu_mesh_grid_starts_gloo_where_there_is_a_card(monkeypatch):
    """The world's backend follows the device asked for, not the
    machine: ``device="cpu"`` starts gloo even where a card exists
    (NCCL carries no CPU tensors)."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        grid = make_mesh_grid(8, device="cpu")
        assert dist.get_backend() == "gloo"
        assert grid.mesh.device_type == "cpu"
        data, _ = grid.shard_rows(torch.arange(16.0)[:, None])
        out = grid.map_reduce(
            lambda _, sl: {"s": (sl["X"][..., 0] * sl["w"]).sum(-1)},
            None, data)
        assert float(out["s"]) == 120.0
    finally:
        dist.destroy_process_group()


# -- the plan cells ----------------------------------------------------------


@pytest.mark.parametrize("cell", sorted(ref.PLAN_CELLS))
def test_plan_cell_matches_jax_mesh(runs, cell):
    ranks, jax = runs
    w, losses = ranks[0]["cells"][cell]["scan"]
    jw, jlosses = jax["cells"][cell]
    near(w, jw, 1e-5 if cell in ref.EXACT_CELLS else 1e-4)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses.shape == (ref.STEPS,)


@pytest.mark.parametrize("cell", sorted(ref.PLAN_CELLS))
def test_scan_matches_python_on_mesh(runs, cell):
    ranks, _ = runs
    for res in ranks:
        scan, py = res["cells"][cell]["scan"], res["cells"][cell]["python"]
        np.testing.assert_array_equal(scan[0], py[0])
        np.testing.assert_array_equal(scan[1], py[1])


@pytest.mark.parametrize("cell", sorted(ref.EXACT_CELLS))
def test_exact_cell_matches_the_grid(runs, cell):
    """Exact wires differ from the single-device grid only in the order
    the lane sums add."""
    ranks, _ = runs
    w, losses = ranks[0]["cells"][cell]["scan"]
    np.testing.assert_allclose(w, grid_cell(cell)[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cell", sorted(ORACLE_CELLS))
def test_compressed_cell_stays_near_exact(runs, cell):
    """At hop 2 each pod quantizes its own half; error feedback keeps
    the trajectory near its exact cell's, and near the grid's."""
    ranks, _ = runs
    w = ranks[0]["cells"][cell]["scan"][0]
    exact = ranks[0]["cells"][ORACLE_CELLS[cell]]["scan"][0]
    np.testing.assert_allclose(w, exact, rtol=0, atol=ORACLE_TOL)
    np.testing.assert_allclose(w, grid_cell(cell)[0], rtol=0, atol=2e-2)


SECTIONS = ("cells", "workloads", "minibatch", "int_leaf", "split",
            "resume", "controller", "n_chips", "big_wire")


def _equal(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(
            a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a,
            b.view(f"u{b.dtype.itemsize}") if b.dtype.kind == "f" else b,
            err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("section", SECTIONS)
def test_replicas_are_bit_identical(runs, section):
    """Every rank returns the same state, history, buffers and decisions,
    bit for bit."""
    ranks, _ = runs
    for r, res in enumerate(ranks[1:], 1):
        _equal(res[section], ranks[0][section], f"rank {r} {section}")


# -- the workloads -----------------------------------------------------------


@pytest.mark.parametrize("name", ref.JAX_WORKLOADS)
def test_workload_matches_jax_mesh(runs, name):
    ranks, jax = runs
    got, want = ranks[0]["workloads"][name], jax["workloads"][name]
    for a, b in zip(got["state"], want["state"]):
        if name == "kmeans":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
        else:
            near(a, b, 1e-4 if name.endswith("int8") else 1e-5)
    assert got["eval"].keys() == want["eval"].keys()
    for k in got["eval"]:
        np.testing.assert_allclose(got["eval"][k], want["eval"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ref.WORKLOADS)
def test_workload_matches_the_grid(runs, name):
    ranks, _ = runs
    got = ranks[0]["workloads"][name]
    state, evals = grid_workload(name)
    if name != "dtree":
        assert len(got["history"]) == ref.WL_STEPS
    else:
        # a level's histogram sums 0/1 weights, exact in any order: the
        # tree is the grid's, bit for bit
        for a, b in zip(got["state"], state):
            np.testing.assert_array_equal(a, b)
    for k in evals:
        np.testing.assert_allclose(got["eval"][k], evals[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_minibatch_fit_matches_the_grid(runs):
    """The sampler's schedule is the same on every rank: a minibatch fit
    on the mesh lands where the grid's does."""
    ranks, _ = runs
    wl, X, y, _ = ref.workload_case(ml, "logreg")
    res = ml.api.fit(wl, make_cpu_grid(ref.N_VDPUS), X, y, **ref.MINIBATCH)
    w, losses = ranks[0]["minibatch"]
    near(w, res.state.numpy(), 1e-5)
    np.testing.assert_allclose(
        losses, [float(h["loss"]) for h in res.history], rtol=1e-5)


def test_integer_leaves_exact_across_grids(runs):
    """Integer statistics cross the compressed slow hop exactly: the mesh
    and the grid agree bit for bit."""
    ranks, _ = runs
    lf, uf, s0 = ref.int_leaf_fns()
    grid = make_cpu_grid(ref.N_VDPUS)
    data, _ = grid.shard_rows(ref.int_leaf_data())
    state, hist = grid.fit(
        init_state=s0, local_fn=lf, update_fn=uf, data=data, steps=4,
        merge_plan=mp.MergePlan(compression=comp.CompressionConfig(bits=8)))
    np.testing.assert_array_equal(ranks[0]["int_leaf"][0],
                                  state["hist"].numpy())
    np.testing.assert_array_equal(
        ranks[0]["int_leaf"][1], np.stack([h["hist"].numpy() for h in hist]))


# -- merge_state on the mesh -------------------------------------------------


def test_ef_buffer_has_a_row_a_pod(runs):
    ranks, _ = runs
    split = ranks[0]["split"]
    assert split["int8_k4"]["shapes"] == {"error": [(2, 6)]}
    assert split["slowmo_k4"]["shapes"] == {"momentum": [(), (6,)]}
    rows = split["int8_k4"]["error"][0]
    assert not np.array_equal(rows[0], rows[1])     # each pod's own


@pytest.mark.parametrize("cell", ["int8_k4", "slowmo_k4"])
def test_split_fits_equal_one_fit(runs, cell):
    """fit(8) + fit(8) with one merge_state equals fit(16), bit for bit:
    the buffer gathered at the end of the first fit resumes each pod's
    row."""
    ranks, _ = runs
    split = ranks[0]["split"][cell]
    np.testing.assert_array_equal(split["two"], split["whole"])


def test_jax_mesh_buffer_resumes_as_in_jax(runs):
    """A JAX mesh fit's (2, 6) EF buffer, through
    ``interop.error_from_numpy``, resumes as JAX resumes it."""
    ranks, jax = runs
    jres = jax["resume"]
    assert jres["error"].shape == (2, 6)
    near(ranks[0]["resume"], jres["w_two"], 1e-4)


# -- the controller and the cost model ---------------------------------------


@pytest.mark.parametrize("name", ["auto", "autotune", "adaptive"])
def test_controlled_fit_on_mesh(runs, name):
    """The controller runs on every rank from agreed timings; its traces
    are equal across ranks (``test_replicas_are_bit_identical``) and
    replay."""
    ranks, _ = runs
    ctl = ranks[0]["controller"][name]
    steps = 32 if name == "autotune" else 16
    assert ctl["losses"].shape == (steps,)
    assert np.isfinite(ctl["w"]).all()
    decisions = ctl["trace"]["decisions"]
    assert sum(d["cadence"] * d["rounds_in_dispatch"]
               for d in decisions) == steps
    assert ctl["trace"]["cadence_trace"] == ctl["cadence_trace"]
    if name == "autotune":
        assert len({d["compression"] for d in decisions}) > 1


def test_n_chips_tracks_the_mesh(runs):
    ranks, _ = runs
    assert ranks[0]["n_chips"] == 4
    grid = make_cpu_grid(ref.N_VDPUS)
    X, y = ref.linreg_data()
    data, n, lf, uf, w0 = ml.make_linreg_step(grid, X, y, lr=0.05)
    assert CostModel.for_fit(grid, lf, uf, w0, data).n_chips == 1


def test_dcn_pricing_flips_the_compression_verdict(runs):
    """On the mesh the slow hop crosses the NIC, so the int8 wire's byte
    saving beats its encode passes; on one grid the hop moves at HBM
    speed and compression cannot win the modelled merge."""
    ranks, _ = runs
    mesh = ranks[0]["big_wire"]
    one = ref.big_wire_merge(make_cpu_grid(ref.N_VDPUS))
    assert mesh["n_chips"] == 4 and one["n_chips"] == 1
    assert mesh["int8"] < mesh["exact"]
    assert one["int8"] > one["exact"]


def test_mesh_prior_prices_overlap_as_its_twin(runs):
    """The port's overlap runs its merge in order on one stream, so on
    the mesh too the prior ranks no ``overlap`` candidate below its
    twin: only a measured probe can promote one."""
    ranks, _ = runs
    us = ranks[0]["big_wire"]["us"]
    for tag in ("exact", "int8"):
        assert us[tag, True] == us[tag, False], tag
