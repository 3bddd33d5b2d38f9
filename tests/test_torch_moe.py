"""The port's Mixture-of-Experts (``models/moe.py``) and the two MoE
configs against the JAX package, on the CPU in float32 at both smoke
configs (phi3.5-moe: 4 experts, top 2; qwen3-moe: 8 experts, top 2):
the configs, the init tree, ``interop.lm_params_from_numpy``, ``moe_body``
with and without capacity drops, its expert shards, the model's forward,
prefill, decode and greedy tokens, ``Model.loss`` and its gradients, three
AdamW steps, ``active_param_count`` and the CLIs.  Inputs are made with
numpy from a seed and JAX's parameters are carried across; the
tolerances are stated beside each test.  The card-only cases are in
``test_torch_cuda.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import serve_lm, train  # noqa: E402
from repro_torch.launch.serve_lm import generate  # noqa: E402
from repro_torch.models import build, moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.tree import tree_flatten_with_names, tree_leaves  # noqa: E402
from torch_parity import rng, to_numpy  # noqa: E402

ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
LR = 3e-4


def _perturb_zeros(tree, r):
    """The init's zero leaves (norm scales) made small and random, so that
    the comparison exercises them."""
    def f(a):
        a = np.asarray(a)
        if not a.any():
            return (r.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree.map(f, tree)


def _pair(arch: str, dtype: str = "float32", seed: int = 3, **moe_change):
    """JAX's model and parameters and the port's, the same numbers."""
    cfg_j = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    cfg_j = dataclasses.replace(cfg_j, dtype=dtype, moe=dataclasses.replace(
        cfg_j.moe, **moe_change))
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, **moe_change))
    params_np = _perturb_zeros(jbuild(cfg_j).init(jax.random.PRNGKey(seed)),
                               rng(41))
    return (jbuild(cfg_j), jax.tree.map(jnp.asarray, params_np),
            build(cfg, "cpu"), interop.lm_params_from_numpy(
                params_np, cfg, device="cpu"))


def _tokens(vocab: int, seed: int, shape=(2, 12)) -> np.ndarray:
    return rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_config_copied_field_for_field(arch):
    for port, jax_cfg in ((configs.get_config(arch),
                           jconfigs.get_config(arch)),
                          (configs.get_smoke_config(arch),
                           jconfigs.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
        assert port.hd == jax_cfg.hd and port.pattern == jax_cfg.pattern
    full = configs.get_config(arch)
    assert full.moe.capacity_factor == 1.25 and full.moe.router_jitter == 0
    assert full.compute_dtype == torch.bfloat16
    assert arch in configs.list_archs()
    build(full, "cpu")                      # accepted; nothing initialised


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_jax_shapes_and_dtypes(arch):
    """bf16: the port's init and JAX's (carried across) have the same leaf
    names, shapes and dtypes; the router stays float32."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="bfloat16")
    want = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(0))),
        cfg, device="cpu")
    got = build(cfg, "cpu").init(0)
    names, leaves = tree_flatten_with_names(got)
    wnames, wleaves = tree_flatten_with_names(want)
    assert names == wnames
    for name, a, b in zip(names, leaves, wleaves):
        assert a.shape == b.shape and a.dtype == b.dtype, name
    E, f, d = cfg.moe.n_experts, cfg.moe.d_ff, cfg.d_model
    for layer in got["layers"]:
        assert sorted(layer) == ["mixer", "moe", "norm1", "norm2"]
        m = layer["moe"]
        assert m["router"].dtype == torch.float32
        assert m["router"].shape == (d, E)
        assert m["w_gate"].shape == m["w_up"].shape == (E, d, f)
        assert m["w_down"].shape == (E, f, d)
        assert m["w_gate"].dtype == torch.bfloat16


def test_init_rule_is_jax_dense_init():
    """dense_init's default fan_in = shape[0]: std 1/√E for the gate and
    up weights, 1/√f for the down weights (fan_in=f), 1/√d for the router
    -- the port's and JAX's sample stds within 3 % of it (2·10^5 draws:
    the sampling error is ~0.3 %)."""
    cfg = dataclasses.replace(
        configs.get_smoke_config(ARCHS[0]), d_model=128,
        moe=dataclasses.replace(configs.get_smoke_config(ARCHS[0]).moe,
                                n_experts=8, d_ff=192))
    cfg_j = dataclasses.replace(
        jconfigs.get_smoke_config(ARCHS[0]), d_model=128,
        moe=dataclasses.replace(jconfigs.get_smoke_config(ARCHS[0]).moe,
                                n_experts=8, d_ff=192))
    got = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    want = jmoe.init_moe(cfg_j, jax.random.PRNGKey(0))
    E, f, d = 8, 192, 128
    for name, std in (("router", d ** -0.5), ("w_gate", E ** -0.5),
                      ("w_up", E ** -0.5), ("w_down", f ** -0.5)):
        for s in (float(got[name].std()), float(np.std(want[name]))):
            assert abs(s / std - 1) < 0.03, (name, s, std)


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_carries_moe_leaves_in_model_order(arch):
    """A bf16 JAX init crosses with every bit kept: each layer's ``moe``
    leaves from the scan's row of that layer, the router float32."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="bfloat16")
    params_np = jax.tree.map(np.asarray,
                             jbuild(cfg_j).init(jax.random.PRNGKey(9)))
    params = interop.lm_params_from_numpy(params_np, cfg, device="cpu")
    scan = params_np["stack"]["scan"][0]["moe"]
    assert len(params["layers"]) == cfg.n_layers
    for i, layer in enumerate(params["layers"]):
        for name in ("w_gate", "w_up", "w_down"):
            assert layer["moe"][name].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                layer["moe"][name].view(torch.int16).numpy(),
                scan[name][i].view(np.int16))
        assert layer["moe"]["router"].dtype == torch.float32
        np.testing.assert_array_equal(layer["moe"]["router"].numpy(),
                                      scan["router"][i])


# ---------------------------------------------------------------------------
# moe_body against _moe_body: float32, y within 1e-5 of max|y| (the expert
# products' sum order), aux within rtol 1e-6, the experts equal
# ---------------------------------------------------------------------------

def _layer_moe(arch, capacity_factor=None, seed=5):
    """Layer 0's MoE parameters of the smoke config (numpy), the port's
    and JAX's configs, and x (T = 48, d) with a shared component that
    skews the router, so that some experts overflow at 1.25."""
    cfg, cfg_j = configs.get_smoke_config(arch), \
        jconfigs.get_smoke_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
            cfg_j.moe, capacity_factor=capacity_factor))
    p = jax.tree.map(lambda a: np.asarray(a)[0], jbuild(cfg_j).init(
        jax.random.PRNGKey(seed))["stack"]["scan"][0]["moe"])
    r = rng(seed)
    x = (r.standard_normal((48, cfg.d_model))
         + 1.5 * r.standard_normal(cfg.d_model)).astype(np.float32)
    return cfg, cfg_j, p, x


def _jax_routes(cfg_j, p, x):
    """JAX's experts and their gap: ``lax.top_k`` of the float32 softmax,
    as ``_moe_body`` computes them, and the smallest gap between the k-th
    and (k+1)-th probabilities of a token."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(p["router"]), -1)
    _, topi = jax.lax.top_k(probs, cfg_j.moe.top_k)
    s = -np.sort(-np.asarray(probs), axis=-1)
    k = cfg_j.moe.top_k
    return np.asarray(topi), float((s[:, k - 1] - s[:, k]).min())


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def _port_p(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", ["config", "n_experts"])
def test_moe_body_matches_jax(arch, cf):
    """At the config's capacity factor (1.25) the skewed input drops pairs
    by capacity; at capacity_factor = n_experts none is dropped.  Either
    way the experts are JAX's (the smallest k-th/(k+1)-th probability gap
    of these inputs is asserted above 1e-4, far above float32's routing
    noise: 4.5e-3 for phi3.5's input, 1.3e-3 for qwen3's), y within 1e-5
    of max|y| and aux within rtol 1e-6."""
    E = configs.get_smoke_config(arch).moe.n_experts
    cfg, cfg_j, p, x = _layer_moe(arch, None if cf == "config" else E)
    topi_j, gap = _jax_routes(cfg_j, p, x)
    assert gap > 1e-4, gap
    pt, xt = _port_p(p), torch.from_numpy(x)
    probs, topw, topi, pos = moe.route(cfg, pt, xt)
    np.testing.assert_array_equal(topi.numpy(), topi_j)
    C = moe.capacity(cfg, 48)
    assert C == max(1, int(48 * cfg.moe.top_k * cfg.moe.capacity_factor / E))
    kept, _ = moe.slots(topi, pos, C, 0, E)
    dropped = int((~kept).sum())
    if cf == "config":
        assert dropped >= 1
    else:
        assert dropped == 0
    y, aux = moe.moe_body(cfg, pt, xt, 0, E)
    yj, auxj = jmoe._moe_body(cfg_j, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x), 0, E)
    _close(y, yj)
    np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32


def test_moe_body_keeps_slots_as_jax_does():
    """Each kept pair sits at its expert's place in token-major order: the
    places of an expert's kept pairs are 0…n−1, in the order of the
    flattened (token, choice) pairs, and at most C of them."""
    cfg, _, p, x = _layer_moe(ARCHS[1])
    probs, topw, topi, pos = moe.route(cfg, _port_p(p), torch.from_numpy(x))
    C = moe.capacity(cfg, x.shape[0])
    kept, slot = moe.slots(topi, pos, C, 0, cfg.moe.n_experts)
    flat_e, flat_pos = topi.reshape(-1), pos.reshape(-1)
    for e in range(cfg.moe.n_experts):
        mine = flat_pos[flat_e == e]
        assert mine.tolist() == list(range(len(mine)))
        assert int(kept.reshape(-1)[flat_e == e].sum()) == min(len(mine), C)
    buf = moe.dispatch(torch.from_numpy(x), kept, slot, cfg.moe.n_experts, C)
    filled = buf.reshape(-1, x.shape[1]).abs().sum(-1) > 0
    assert int(filled.sum()) == int(kept.sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_shards_sum_to_the_whole(arch):
    """Two shards (``e_offset`` 0 and E/2, ``n_local`` E/2), each with its
    experts' weights: their partial outputs sum to the whole bit for bit
    (a pair off the shard adds 0), as JAX's ``psum`` combines them, and
    each partial equals JAX's within 1e-5 of max|y|; both shards' aux is
    the whole's."""
    cfg, cfg_j, p, x = _layer_moe(arch)
    E = cfg.moe.n_experts
    n = E // 2
    xt = torch.from_numpy(x)
    whole, aux = moe.moe_body(cfg, _port_p(p), xt, 0, E)
    total = torch.zeros_like(whole)
    for off in (0, n):
        part = {k: (v if k == "router" else v[off:off + n])
                for k, v in p.items()}
        y, a = moe.moe_body(cfg, _port_p(part), xt, off, n)
        yj, aj = jmoe._moe_body(cfg_j, jax.tree.map(jnp.asarray, part),
                                jnp.asarray(x), off, n)
        _close(y, yj)
        assert torch.equal(a, aux)
        total = total + y
    assert torch.equal(total, whole)


def test_moe_ffn_routes_the_whole_batch():
    """(B, S, d) is routed as B·S tokens together: the capacity of the
    call is that of B·S, so one sequence's drops depend on the other's
    tokens, as in JAX."""
    cfg, _, p, x = _layer_moe(ARCHS[1])
    xt = torch.from_numpy(x).reshape(2, 24, -1)
    y, aux = moe.moe_ffn(cfg, _port_p(p), xt)
    y2, aux2 = moe.moe_body(cfg, _port_p(p), xt.reshape(48, -1), 0,
                            cfg.moe.n_experts)
    assert torch.equal(y.reshape(48, -1), y2) and torch.equal(aux, aux2)
    alone, _ = moe.moe_ffn(cfg, _port_p(p), xt[:1])
    assert not torch.equal(alone[0], y[0])


def test_log_routes_records_each_call():
    cfg, _, p, x = _layer_moe(ARCHS[1])
    xt = torch.from_numpy(x)
    with moe.log_routes() as outer:
        moe.moe_body(cfg, _port_p(p), xt, 0, cfg.moe.n_experts)
        with moe.log_routes() as inner:
            moe.moe_body(cfg, _port_p(p), xt[:8], 0, cfg.moe.n_experts)
    moe.moe_body(cfg, _port_p(p), xt, 0, cfg.moe.n_experts)
    assert len(outer) == 2 and len(inner) == 1
    topi, kept = outer[0]
    assert topi.shape == kept.shape == (48, cfg.moe.top_k)
    assert kept.dtype == torch.bool and not bool(kept.all())
    assert not moe._ROUTE_LOGS


# ---------------------------------------------------------------------------
# the smoke models end to end: float32, JAX's parameters; logits within
# 2e-4 (tests/test_torch_models.py's bar); tokens equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch):
    jmodel, params_j, model, params = _pair(arch)
    toks = _tokens(model.cfg.vocab_size, 62)
    with moe.log_routes() as log:
        got = tfm.lm_forward(model.cfg, params, torch.from_numpy(toks))
    want, _ = jtfm.lm_forward(jmodel.cfg, params_j, jnp.asarray(toks))
    assert got.shape == want.shape == (2, 12, tfm.padded_vocab(model.cfg))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    assert len(log) == model.cfg.n_layers
    pre = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    want_pre = jmodel.prefill(params_j, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(to_numpy(pre), np.asarray(want_pre),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_and_greedy_tokens_match_jax(arch):
    """8 decode steps' logits within 2e-4 (T = B = 2 a step: C = 1, so
    decode drops pairs, as JAX's), then 8 greedy tokens equal (the port's
    ``generate`` against JAX's serve loop)."""
    jmodel, params_j, model, params = _pair(arch)
    toks = _tokens(model.cfg.vocab_size, 42, (2, 8))
    P, n_new = 8, 8
    assert moe.capacity(model.cfg, 2) == 1
    jcache = jmodel.init_cache(2, P + n_new)
    cache = model.init_cache(2, P + n_new)
    with moe.log_routes() as log:
        for t in range(P):
            jl, jcache = jmodel.decode_step(params_j, jcache,
                                            jnp.asarray(toks[:, t:t + 1]),
                                            jnp.int32(t))
            pl, cache = model.decode_step(params, cache,
                                          torch.from_numpy(toks[:, t:t + 1]),
                                          t)
            np.testing.assert_allclose(to_numpy(pl), np.asarray(jl),
                                       atol=2e-4, rtol=2e-4)
    assert sum(int((~kept).sum()) for _, kept in log) > 0
    tok = jnp.argmax(jl[:, -1, :model.cfg.vocab_size], axis=-1)[:, None]
    want = [tok]
    for t in range(P, P + n_new - 1):
        jl, jcache = jmodel.decode_step(params_j, jcache, tok, jnp.int32(t))
        tok = jnp.argmax(jl[:, -1, :model.cfg.vocab_size], axis=-1)[:, None]
        want.append(tok)
    res = generate(model, params, torch.from_numpy(toks).long(), n_new)
    np.testing.assert_array_equal(to_numpy(res.tokens),
                                  np.asarray(jnp.concatenate(want, axis=1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_replays_prefill_without_drops(arch):
    """At capacity_factor = n_experts nothing is dropped on either path,
    so the port's decode of a sequence gives its forward's logits within
    2e-4: the cross-path identity ``chip_smoke.py`` holds on the card."""
    E = configs.get_smoke_config(arch).moe.n_experts
    _, _, model, params = _pair(arch, capacity_factor=float(E))
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, 43, (2, 10)))
    full = tfm.lm_forward(model.cfg, params, toks)
    cache = model.init_cache(2, 10)
    steps = []
    for t in range(10):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(to_numpy(torch.stack(steps, dim=1)),
                               to_numpy(full), atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# training: the loss within rtol 1e-5, every gradient leaf within 1e-4 of
# its max|g| (tests/test_torch_lm_train.py's bars), the router's included
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jmodel, params_j, model, params = _pair(arch)
    toks = _tokens(model.cfg.vocab_size, 63, (2, 24))
    batch = {"tokens": torch.from_numpy(toks)}
    loss, metrics, grads = train.loss_and_grads(model, params, batch)
    loss = loss.detach()
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(params_j)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmet["aux"]),
                               rtol=1e-5)
    assert float(metrics["aux"]) > 0
    want = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads),
                                        model.cfg, device="cpu")
    names, wants = tree_flatten_with_names(want)
    got = tree_leaves(grads)
    assert len(got) == len(wants)
    for name, g, w in zip(names, got, wants):
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= 1e-4 * scale, name
    assert sum("['router']" in n for n in names) == model.cfg.n_layers


# float32: losses within rtol 1e-5, the update (master - init) within
# relative L2 1e-3 of JAX's and every master element within LR / 3, the
# bars of test_torch_lm_train.py::test_three_adamw_steps_match_jax
@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_jax(arch):
    jmodel, params_j, model, params = _pair(arch)
    jopt, opt = jadamw(LR), adamw(LR)

    @jax.jit
    def jstep(state, batch):
        (loss, met), grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, batch), has_aux=True)(state["params"])
        new_p, new_o = jopt.update(grads, state["opt"], state["params"])
        return {"params": new_p, "opt": new_o}, {"loss": loss, **met}

    step = train.make_step_fn(model, opt)
    jstate = {"params": params_j, "opt": jopt.init(params_j)}
    state = {"params": params, "opt": opt.init(params)}
    init = [p.float() for p in tree_leaves(params)]
    for i in range(3):
        toks = _tokens(model.cfg.vocab_size, 70 + i, (2, 24))
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    assert int(state["opt"].step) == 3
    master = tree_leaves(state["opt"].inner["master"])
    jmaster = tree_leaves(interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jstate["opt"].inner["master"]), model.cfg,
        device="cpu"))
    du = torch.cat([(m - p0).flatten() for m, p0 in zip(master, init)])
    dj = torch.cat([(m - p0).flatten() for m, p0 in zip(jmaster, init)])
    assert float((du - dj).norm() / dj.norm()) <= 1e-3
    assert float((du - dj).abs().max()) <= LR / 3


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_matches_jax(arch):
    jmodel, params_j, model, params = _pair(arch)
    got = model.active_param_count(params)
    assert got == jmodel.active_param_count(params_j)
    assert model.param_count(params) == jmodel.param_count(params_j)
    assert got < model.param_count(params)
    dense = build(configs.get_smoke_config("qwen2-0.5b"), "cpu")
    p = dense.init(0)
    assert dense.active_param_count(p) == dense.param_count(p)


def test_backward_is_deterministic_with_drops():
    """Two gradient computations of one batch through a bf16 MoE model
    with capacity drops are bit-equal (the card's case is in
    test_torch_cuda.py)."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCHS[1]),
                              dtype="bfloat16")
    model = build(cfg, "cpu")
    params = model.init(4)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, 64, (2, 24)))}
    a = tree_leaves(train.loss_and_grads(model, params, batch)[2])
    b = tree_leaves(train.loss_and_grads(model, params, batch)[2])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    router = [g for n, g in zip(tree_flatten_with_names(params)[0], a)
              if "['router']" in n]
    assert router and all(bool(torch.isfinite(g).all()) and g.abs().max() > 0
                          for g in router)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_smoke_config(arch, capsys):
    out = train.main(["--arch", arch, "--smoke", "--steps", "3", "--batch",
                      "2", "--seq", "32", "--device", "cpu"])
    assert out["final_step"] == 3 and out["restarts"] == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("step 0: loss=")
    assert lines[-1] == "done: 3 steps, restarts=0"


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_smoke_config(arch, capsys):
    serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                   "2", "--prompt-len", "4", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch} (smoke config" in out
    assert "decode : 3 tokens x 2 seqs" in out
