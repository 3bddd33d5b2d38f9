"""The compiled engine of the port against the JAX package: the chunk
runners (``PimGrid.make_runner``, ``merge_plan.pipeline_runners``), their
cache and static-buffer rules, and the decode step with its position on
the device.

On the CPU a chunk runner runs its rounds eagerly on the same static
carry a captured graph replays on the card (``core.graphs``), so the
copy-in, copy-out and aliasing rules run here; the card's graphs are
held against ``engine="python"`` by ``chip_smoke.py``'s ``train_graph``
phase and ``test_torch_cuda.py``.  Inputs are made with numpy from a
seed.  The JAX side runs under ``dispatch.use_kernels(False)``, jitted;
the tolerances are those of the files named beside each test (the
jitted JAX runner divides by reciprocal multiplies where the port
divides)."""

import doctest

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core.mlalgos import KMeans as JKMeans  # noqa: E402
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.core.mlalgos import LogReg as JLogReg  # noqa: E402
from repro.distributed import merge_plan as jmp  # noqa: E402
from repro.distributed.compression import (  # noqa: E402
    CompressionConfig as JCompressionConfig)
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
import repro_torch.core.graphs  # noqa: E402
import repro_torch.core.pim  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.core import graphs, make_cpu_grid  # noqa: E402
from repro_torch.core.mlalgos import KMeans, LinReg, LogReg, api  # noqa: E402
from repro_torch.core.mlalgos.linreg import train_linreg  # noqa: E402
from repro_torch.distributed import merge_plan as mp  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    CompressionConfig)
from repro_torch.launch.serve_lm import DecodeStep, generate  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.serving import PredictRunner  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_parity import (blobs, classification, regression, rng,  # noqa: E402
                          to_numpy, to_torch)

LANES, ROWS, D = 8, 603, 16          # 603 rows: the last lane is padded
LENGTH = 5                           # rounds a chunk in the runner tests
ARCH = "qwen2-0.5b"


def _close(got, want, bound):
    want = np.asarray(want)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                               atol=bound * np.abs(want).max())


# -- make_runner against JAX's ---------------------------------------------


def _programs(name):
    """(JAX program, port program) of one configuration, the JAX one
    bound with the kernels off; K-means starts from JAX's centroids."""
    if name == "kmeans-int8":
        X = blobs(7, ROWS, 6, 4)
        jw, pw, y = JKMeans(k=4, precision="int8"), KMeans(
            k=4, precision="int8"), None
    elif name.startswith("linreg"):
        X, y = regression(1, ROWS, D)
        jw, pw = JLinReg(lr=0.1, precision="int8"), LinReg(
            lr=0.1, precision="int8")
    else:
        X, y = classification(0, ROWS, D)
        kw = ({"precision": "int8", "sigmoid": "lut"}
              if name == "logreg-int8-lut" else {})
        jw, pw = JLogReg(lr=0.5, **kw), LogReg(lr=0.5, **kw)
    with jdispatch.use_kernels(False):
        jprog = jw.bind(jax_grid(LANES), jnp.asarray(X),
                        None if y is None else jnp.asarray(y))
    prog = pw.bind(make_cpu_grid(LANES), X, y)
    if name == "kmeans-int8":
        prog.state0 = interop.state_from_numpy(
            np.asarray(jprog.state0), device="cpu")
    return jprog, prog


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("name", ["linreg-int8", "logreg-fp32-exact",
                                  "logreg-int8-lut", "kmeans-int8"])
def test_make_runner_against_jax(name, k):
    """``runner(state, data, length=5)``: the state and every stacked
    metric, in JAX's layout (``(L, ...)``, ``(L, k, ...)`` at cadence k),
    within ``test_torch_train.py``'s bars (state 1e-5·max|w|, losses rtol
    1e-4) and ``test_torch_kmeans.py``'s (centroids atol 1e-4 rtol 1e-5,
    sse rtol 1e-5, moved atol 1e-4)."""
    jprog, prog = _programs(name)
    with jdispatch.use_kernels(False):
        jrun = jprog.grid.make_runner(jprog.local_fn, jprog.update_fn,
                                      merge_every=k)
        jstate, jm = jrun(jprog.state0, jprog.data, length=LENGTH)
    run = prog.grid.make_runner(prog.local_fn, prog.update_fn,
                                merge_every=k)
    state, m = run(prog.state0, prog.data, length=LENGTH)
    assert sorted(m) == sorted(jm)
    for key in m:
        assert tuple(m[key].shape) == tuple(np.shape(jm[key])), key
    if name == "kmeans-int8":
        np.testing.assert_allclose(to_numpy(state), np.asarray(jstate),
                                   atol=1e-4, rtol=1e-5)
        np.testing.assert_allclose(to_numpy(m["sse"]), np.asarray(jm["sse"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(to_numpy(m["moved"]),
                                   np.asarray(jm["moved"]), atol=1e-4)
    else:
        _close(state, jstate, 1e-5)
        np.testing.assert_allclose(to_numpy(m["loss"]),
                                   np.asarray(jm["loss"]), rtol=1e-4)
    assert run._cache_size() == 1


@pytest.mark.parametrize("k", [1, 4])
def test_runner_chunks_equal_the_python_engine(k):
    """Two chunks of the runner equal ten eager rounds bit for bit, and
    feeding the returned live carry back costs no copy."""
    _, prog = _programs("logreg-int8-lut")
    ref = prog.fit(steps=10 * k, engine="python", merge_every=k)
    run = prog.grid.make_runner(prog.local_fn, prog.update_fn,
                                merge_every=k)
    state, a = run(prog.state0, prog.data, length=4)
    again, b = run(state, prog.data, length=6)
    assert again is state
    assert torch.equal(state, ref.state)
    losses = torch.cat([a["loss"].reshape(-1), b["loss"].reshape(-1)])
    assert torch.equal(losses, torch.stack([m["loss"]
                                            for m in ref.history]))


# -- pipeline_runners against JAX's ------------------------------------------


PLANS = {
    "slowmo-k4": (dict(merge_every=4, overlap=False, compression=None),
                  (mp.SlowMo(), jmp.SlowMo())),
    "int8-ef-k1": (dict(merge_every=1, overlap=False, compression="int8"),
                   (mp.AverageCommit(), jmp.AverageCommit())),
    "overlap-k4": (dict(merge_every=4, overlap=True, compression=None),
                   (mp.AverageCommit(), jmp.AverageCommit())),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_pipeline_runner_against_jax(plan):
    """One chunk of 5 rounds of LogReg int8 + LUT through
    ``pipeline_runners(...)["runner"]``: state within 1e-4·max|w| and the
    losses within rtol 1e-4, ``test_torch_merge_plan.py``'s and
    ``test_torch_overlap.py``'s bars for quantized trajectories.  The
    port's EF buffer starts as ``None`` (sized by the warm-up round),
    JAX's from its ``wire_spec``."""
    kw, (outer, jouter) = PLANS[plan]
    k, overlap = kw["merge_every"], kw["overlap"]
    cfg = CompressionConfig(bits=8) if kw["compression"] else None
    jcfg = JCompressionConfig() if kw["compression"] else None
    jprog, prog = _programs("logreg-int8-lut")
    with jdispatch.use_kernels(False):
        jrs = jmp.pipeline_runners(
            jprog.grid, jprog.local_fn, jprog.update_fn, merge_every=k,
            overlap=overlap, compression=jcfg, state_wire=k > 1,
            outer=jouter)
        jef = None
        if jcfg is not None:
            jef = jmp.init_merge_error(jprog.grid, jmp.wire_spec(
                jprog.grid, jprog.local_fn, jprog.update_fn, jprog.state0,
                jprog.data, merge_every=k))
        js0 = jprog.state0
        jcarry = (js0, jef, jouter.init(js0))
        if overlap:
            jcarry = (js0, jrs["prologue"](js0, jprog.data), jef,
                      jouter.init(js0))
        jcarry, jm = jrs["runner"](jcarry, jprog.data, length=LENGTH)
    rs = mp.pipeline_runners(prog.grid, prog.local_fn, prog.update_fn,
                             merge_every=k, overlap=overlap, compression=cfg,
                             state_wire=k > 1, outer=outer)
    s0 = prog.state0
    carry = (s0, None, outer.init(s0))
    if overlap:
        carry = (s0, rs["prologue"](s0, prog.data), None, outer.init(s0))
    carry, m = rs["runner"](carry, prog.data, length=LENGTH)
    assert tuple(m["loss"].shape) == tuple(np.shape(jm["loss"]))
    _close(carry[0], jcarry[0], 1e-4)
    np.testing.assert_allclose(to_numpy(m["loss"]), np.asarray(jm["loss"]),
                               rtol=1e-4)
    if cfg is not None:
        assert tuple(carry[1]["g"].shape) == tuple(np.shape(jcarry[1]["g"]))
    assert mp.pipeline_runners(
        prog.grid, prog.local_fn, prog.update_fn, merge_every=k,
        overlap=overlap, compression=cfg, state_wire=k > 1,
        outer=outer) is rs


@pytest.mark.parametrize("kw", [
    dict(merge_every=4, outer=mp.SlowMo()),
    dict(merge_every=1, compression=CompressionConfig(bits=8)),
    dict(merge_every=4, overlap=True, compression=CompressionConfig(bits=8),
         outer=mp.SlowMo()),
], ids=["slowmo-k4", "int8-ef-k1", "overlap-int8-slowmo-k4"])
def test_plan_chunks_equal_the_python_engine(kw):
    """``run_fit`` on the chunk runners equals its eager rounds bit for
    bit, state, history and the holder's EF buffer and momentum, over
    two fits (the holder carried across) with a trailing round."""
    _, prog = _programs("logreg-int8-lut")
    plan = mp.MergePlan(cadence=kw["merge_every"],
                        overlap=kw.get("overlap", False),
                        compression=kw.get("compression"),
                        outer=kw.get("outer", mp.AverageCommit()))
    held = [{}, {}]
    for _ in range(2):
        a = prog.fit(steps=11, engine="python", merge_plan=plan,
                     merge_state=held[0])
        b = prog.fit(steps=11, scan_chunk=2, merge_plan=plan,
                     merge_state=held[1])
        assert torch.equal(a.state, b.state)
        for m, n in zip(a.history, b.history, strict=True):
            assert torch.equal(m["loss"], n["loss"])
        assert sorted(held[0]) == sorted(held[1])
        for x, y in zip(tree_leaves(held[0]), tree_leaves(held[1])):
            assert torch.equal(x, y)


# -- the cache (tests/test_scan_engine.py, tests/test_merge_cadence.py) -------


def _toy(grid, rows=32, d=2):
    X = torch.arange(rows * d, dtype=torch.float32).reshape(rows, d)
    data, n = grid.shard_rows(X)

    def local_fn(w, sl):
        return {"g": (sl["X"] * sl["w"][..., None]).sum(-2)}

    def update_fn(w, merged):
        return w - 0.01 * merged["g"] / n, {"gn": merged["g"].sum()}

    return data, local_fn, update_fn


def _fit(grid, data, lf, uf, steps, **kw):
    return grid.fit(init_state=torch.zeros(data["X"].shape[-1]),
                    local_fn=lf, update_fn=uf, data=data, steps=steps, **kw)


def _steps_not_a_multiple_of_the_chunk():
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid)
    w, hist = _fit(grid, data, lf, uf, 11, scan_chunk=4)
    w2, _ = _fit(grid, data, lf, uf, 11, scan_chunk=64)
    assert len(hist) == 11 and torch.equal(w, w2)


def _a_callback_every_step():
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid)
    seen = []
    _fit(grid, data, lf, uf, 10, scan_chunk=3,
         callback=lambda s, state, m: seen.append(s))
    assert seen == list(range(10))


def _zero_steps():
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid)
    w0 = torch.ones(2)
    w, hist = grid.fit(init_state=w0, local_fn=lf, update_fn=uf,
                       data=data, steps=0)
    assert hist == [] and torch.equal(w, w0)


def _no_recapture_on_repeat():
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid, 64, 3)
    runner = grid.make_runner(lf, uf)
    before = graphs.Graph.captures
    for _ in range(3):
        _fit(grid, data, lf, uf, 40, scan_chunk=32)
    assert grid.make_runner(lf, uf) is runner
    assert runner._cache_size() <= 2
    assert graphs.Graph.captures - before == 2       # the 32 and the 8


def _equal_closures_share_a_runner():
    grid = make_cpu_grid(4)
    X, y = regression(3, 200, 4)
    train_linreg(grid, X, y, lr=0.1, steps=5)
    n_before = len(grid._tuning_cache)
    train_linreg(grid, X, y, lr=0.1, steps=5)
    assert len(grid._tuning_cache) == n_before


def _hyperparameters_do_not_collide():
    grid = make_cpu_grid(4)
    X, y = regression(3, 200, 4)
    r1 = train_linreg(grid, X, y, lr=0.1, steps=30)
    r2 = train_linreg(grid, X, y, lr=0.01, steps=30)
    assert float((r1.w - r2.w).abs().max()) > 1e-6


def _default_args_do_not_collide():
    grid = make_cpu_grid(4)
    data, lf, _ = _toy(grid, 16)

    def make_update(lr):
        def update_fn(w, merged, lr=lr):
            return w - lr * merged["g"] / 16, {}
        return update_fn

    w1, _ = _fit(grid, data, lf, make_update(0.1), 3)
    w2, _ = _fit(grid, data, lf, make_update(0.01), 3)
    assert float((w1 - w2).abs().max()) > 1e-8


def _one_runner_per_cadence():
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid, 64, 3)

    def sweep():
        out = {}
        for k in (1, 2, 4):
            _fit(grid, data, lf, uf, 8, merge_every=k)
            out[k] = grid.make_runner(lf, uf, merge_every=k)
        return out

    first = sweep()
    size = len(grid._tuning_cache)
    second = sweep()
    assert len(grid._tuning_cache) == size
    assert all(first[k] is second[k] for k in (1, 2, 4))
    assert len({id(r) for r in first.values()}) == 3


def _cadence_graphs_bounded():
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid)
    for _ in range(3):
        _fit(grid, data, lf, uf, 20, merge_every=4, scan_chunk=3)
    assert grid.make_runner(lf, uf, merge_every=4)._cache_size() <= 2


def _cadence_zero_raises():
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid, 8)
    with pytest.raises(ValueError):
        grid.make_runner(lf, uf, merge_every=0)
    with pytest.raises(ValueError):
        _fit(grid, data, lf, uf, 1, merge_every=0)


CACHE_CASES = {f.__name__.strip("_"): f for f in (
    _steps_not_a_multiple_of_the_chunk, _a_callback_every_step, _zero_steps,
    _no_recapture_on_repeat, _equal_closures_share_a_runner,
    _hyperparameters_do_not_collide, _default_args_do_not_collide,
    _one_runner_per_cadence, _cadence_graphs_bounded, _cadence_zero_raises)}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_cache_rules(case):
    """JAX's scan-engine and cadence cache cases on the chunk runners."""
    CACHE_CASES[case]()


# -- the static buffers -------------------------------------------------------


def test_init_state_is_copied_in_and_the_result_cloned_out():
    """The caller's ``init_state`` is never written, and a later fit
    leaves an earlier result as it was (the runner's carry is live)."""
    _, prog = _programs("logreg-int8-lut")
    w0 = torch.full((D,), 0.25)
    keep = w0.clone()
    state = prog.grid.fit(init_state=w0, local_fn=prog.local_fn,
                          update_fn=prog.update_fn, data=prog.data,
                          steps=6)[0]
    first = state.clone()
    prog.grid.fit(init_state=torch.zeros(D), local_fn=prog.local_fn,
                  update_fn=prog.update_fn, data=prog.data, steps=6)
    assert torch.equal(w0, keep)
    assert torch.equal(state, first)


def test_callback_sees_the_end_of_chunk_state():
    """Every step of a chunk sees the chunk's end state, the live carry
    (the next chunk overwrites it), as under JAX's donated carry."""
    _, prog = _programs("logreg-int8-lut")
    ref = []
    prog.fit(steps=6, engine="python",
             callback=lambda i, s, m: ref.append(s.clone()))
    seen, live = [], []

    def cb(i, s, m):
        seen.append(s.clone())
        live.append(s)

    res = prog.fit(steps=6, scan_chunk=3, callback=cb)
    for i in range(6):
        assert torch.equal(seen[i], ref[2 if i < 3 else 5])
    assert live[0] is live[5]
    assert torch.equal(live[0], res.state) and live[0] is not res.state


def test_data_is_held_weakly():
    """A binding goes with its data: a runner's graphs never keep a
    dataset alive, at most two bindings live a runner and four chunk
    lengths a binding."""
    grid = make_cpu_grid(4)
    data, lf, uf = _toy(grid)
    runner = grid.make_runner(lf, uf)
    _fit(grid, data, lf, uf, 4)
    assert runner._cache_size() == 1
    del data
    assert runner._cache_size() == 0
    keep = [_toy(grid)[0] for _ in range(3)]
    for d in keep:
        _fit(grid, d, lf, uf, 4)
    assert runner._cache_size() == 2
    # and at most four chunk lengths a binding, the least recent dropped
    for steps in (1, 2, 3, 4, 5, 6):
        _fit(grid, keep[-1], lf, uf, steps)
    assert runner._cache_size() == 1 + runner.MAX_LENGTHS


def test_fit_and_serving_entries_do_not_evict_each_other():
    """One grid's cache holds a server's bucket graphs and the fits'
    chunk runners under budgets of their own: 40 fits with 40 runners
    leave the warm ladder in place, and the server captures nothing
    more."""
    grid = make_cpu_grid(4)
    X, y = regression(4, 128, 4)
    state = api.fit(LinReg(lr=0.05), grid, X, y, steps=2).state
    server = PredictRunner(LinReg(lr=0.05), state, grid=grid,
                           buckets=(8, 32))
    server.warmup(4)
    for i in range(40):
        train_linreg(grid, X, y, lr=0.01 + 0.001 * i, steps=2)
    server.predict(X[:20])
    assert server.counters()["steady_compile_misses"] == 0
    kinds = [mp._kind(k) for k in grid._tuning_cache]
    assert kinds.count("serving") == 2
    assert kinds.count("fit_runner") == mp._CACHE_MAX


def test_graph_outputs_are_static():
    """On the CPU a ``Graph`` replays its function on the same buffers
    and copies into the same outputs; a capture is counted."""
    x = torch.ones(3)
    before = graphs.Graph.captures
    g = graphs.Graph("cpu")
    assert g.capture(lambda: x * 2.0) is None
    g.replay()
    out = g.outputs
    x.fill_(5.0)
    g.replay()
    assert g.outputs is out and out.tolist() == [10.0, 10.0, 10.0]
    assert graphs.Graph.captures == before + 1


# -- the decode step with its position on the device --------------------------


@pytest.fixture(scope="module")
def qwen():
    cfg_j = jconfigs.get_smoke_config(ARCH)
    r = rng(43)

    def f(a):
        a = np.asarray(a)
        return a if a.any() else (r.standard_normal(a.shape) * 0.1
                                  ).astype(a.dtype)

    params_np = jax.tree.map(f, jbuild(cfg_j).init(jax.random.PRNGKey(4)))
    cfg = configs.get_smoke_config(ARCH)
    params = interop.lm_params_from_numpy(params_np, cfg, device="cpu")
    toks = rng(44).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return cfg_j, jax.tree.map(jnp.asarray, params_np), cfg, params, toks


def test_attn_decode_with_a_tensor_pos_against_jax():
    """One attention layer, 6 decode steps with ``pos`` a 0-dim int32
    tensor against JAX's traced ``pos`` (``jnp.int32(t)``): outputs and
    cache within 2e-4 (``test_torch_models.py``'s tolerance)."""
    cfg_j = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    r = rng(45)
    d, H, Kh, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": r.standard_normal((d, H, Dh)) * 0.1,
         "wk": r.standard_normal((d, Kh, Dh)) * 0.1,
         "wv": r.standard_normal((d, Kh, Dh)) * 0.1,
         "wo": r.standard_normal((H, Dh, d)) * 0.1,
         "bq": r.standard_normal((H, Dh)) * 0.1,
         "bk": r.standard_normal((Kh, Dh)) * 0.1,
         "bv": r.standard_normal((Kh, Dh)) * 0.1}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (r.standard_normal((2, 6, d)) * 0.5).astype(np.float32)
    jcache = jatt.init_cache(cfg_j, 2, 6)
    cache = att.init_cache(cfg, 2, 6, "cpu")
    pt = {k: to_torch(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for t in range(6):
        want, jcache = jatt.attn_decode(cfg_j, jp, jnp.asarray(x[:, t:t + 1]),
                                        jcache, jnp.int32(t))
        got, cache = att.attn_decode(cfg, pt, to_torch(x[:, t:t + 1]),
                                     cache, torch.tensor(t,
                                                         dtype=torch.int32))
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(to_numpy(cache["k"]), np.asarray(jcache["k"]),
                               atol=2e-4, rtol=2e-4)


def test_lm_decode_step_with_a_tensor_pos_against_jax(qwen):
    """The smoke qwen2, 8 decode steps with ``pos`` on the device against
    JAX's ``decode_step`` at ``jnp.int32(t)`` within 2e-4, then
    ``generate``'s greedy tokens equal JAX's serve loop."""
    cfg_j, params_j, cfg, params, toks = qwen
    jmodel, model = jbuild(cfg_j), build(cfg, "cpu")
    P, n_new = 8, 4
    jcache = jmodel.init_cache(2, P + n_new)
    cache = model.init_cache(2, P + n_new)
    pos = torch.zeros((), dtype=torch.int32)
    for t in range(P):
        jl, jcache = jmodel.decode_step(params_j, jcache,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
        pl, cache = model.decode_step(params, cache,
                                      to_torch(toks[:, t:t + 1]), pos)
        pos += 1
        np.testing.assert_allclose(to_numpy(pl), np.asarray(jl), atol=2e-4,
                                   rtol=2e-4)
    tok = jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1)[:, None]
    want = [tok]
    for t in range(P, P + n_new - 1):
        jl, jcache = jmodel.decode_step(params_j, jcache, tok, jnp.int32(t))
        tok = jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1)[:, None]
        want.append(tok)
    res = generate(model, params, to_torch(toks[:, :P]).long(), n_new)
    np.testing.assert_array_equal(to_numpy(res.tokens),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_decode_step_equals_the_eager_decode(qwen):
    """``DecodeStep``'s static buffers (the token and ``pos`` written by
    the step itself) give the eager loop's logits and tokens bit for
    bit, and a reset starts a second sequence afresh."""
    _, _, cfg, params, toks = qwen
    model = build(cfg, "cpu")
    P, n_new = 6, 5
    prompts = to_torch(toks[:, :P]).long()
    cache = model.init_cache(2, P + n_new)
    for t in range(P):
        logits, cache = model.decode_step(params, cache,
                                          prompts[:, t:t + 1], t)
    eager = [torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]]
    for t in range(P, P + n_new - 1):
        logits, cache = model.decode_step(params, cache, eager[-1], t)
        eager.append(torch.argmax(logits[:, -1, :cfg.vocab_size],
                                  -1)[:, None])
    step = DecodeStep(model, params, 2, P + n_new)
    for _ in range(2):
        step.reset()
        for t in range(P):
            step(prompts[:, t:t + 1])
        got = [step.tok.clone()]
        for _ in range(n_new - 1):
            out = step()
            got.append(step.tok.clone())
        assert torch.equal(torch.cat(got, 1), torch.cat(eager, 1))
        assert torch.equal(out, logits)
        assert int(step.pos) == P + n_new - 1


def test_dot_kernel_nodes_reads_kernel_statements_once():
    """``Graph.kernel_nodes``' parser: one entry a kernel node, however
    long its label, memsets and edges (with attributes) skipped."""
    dot = ('digraph dot {\nsubgraph cluster_1 {\n'
           '"graph_1_node_0"[style="solid" label="0\nKERNEL\nID: 0\n'
           'void fxp_rows16_kernel(signed char const*, int)\n"];\n'
           '"graph_1_node_1"[label="1\nMEMSET\n"];\n'
           '"graph_1_node_2" [label="2\nKERNEL\nlut_kernel(float*)"];\n'
           '"graph_1_node_0" -> "graph_1_node_1"[arrowhead=normal];\n'
           '"graph_1_node_1" -> "graph_1_node_2";\n}\n}\n')
    nodes = graphs.dot_kernel_nodes(dot)
    assert len(nodes) == 2
    assert "fxp_rows16_kernel" in nodes[0] and "lut_kernel" in nodes[1]
    assert graphs.dot_kernel_nodes("digraph dot {\n}\n") == []


def test_graph_counts_replays_and_launches_no_kernel_on_the_cpu():
    g = graphs.Graph("cpu")
    box = torch.zeros(())
    g.capture(lambda: box.add_(1))
    for _ in range(3):
        g.replay()
    assert g.replays == 3 and float(box) == 3.0
    assert g.kernel_nodes() == [] and g in graphs.Graph.live()


def test_doc_examples():
    failures, _ = doctest.testmod(repro_torch.core.graphs)
    assert failures == 0
    failures, _ = doctest.testmod(repro_torch.core.pim)
    assert failures == 0
