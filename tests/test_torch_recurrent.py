"""The port's recurrent and hybrid LMs against the JAX package: the
Mamba-2 mixer (``models/ssm.py``), the RG-LRU block (``models/rglru.py``)
and the local-attention ring buffer (``attn_decode(window=)``) each
against JAX's on the same inputs, and the mamba2-370m and
recurrentgemma-2b smoke models end to end (init, forward, loss and its
gradients, prefill, greedy decode, the captured decode step, bf16) with
JAX's parameters carried across by ``interop.lm_params_from_numpy``.
Inputs are made with numpy from a seed; JAX's results are computed once
a module.  No kernel of the port lies on these paths.

Tolerances (float32): a mixer's output and state within 1e-5 of its
max|value| (the SSD's contractions, the scan's tree and softplus's
formula sum and round in another order than XLA); logits within 1e-5 x
max|logit|; gradients within 1e-4 x max|g| a leaf; the port's decode
against its forward within 2e-4, the bar of JAX's own
``tests/test_models.py``."""

import dataclasses
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.launch import serve_lm, train  # noqa: E402
from repro_torch.launch.serve_lm import DecodeStep, generate  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import (tree_flatten_with_names,  # noqa: E402
                              tree_leaves)
from torch_parity import rng, to_numpy, to_torch  # noqa: E402

ARCHS = ("mamba2-370m", "recurrentgemma-2b")
SEQ = 16            # two SSD chunks of 8; two turns of the window of 8
LOGIT_TOL, GRAD_TOL, DECODE_TOL = 1e-5, 1e-4, 2e-4


def _perturb_zeros(tree, r):
    """The init's zero leaves (biases, norm scales) made small and random,
    so that the comparison exercises them."""
    def f(a):
        a = np.asarray(a)
        if not a.any():
            return (r.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree.map(f, tree)


def _rel(got, want, tol):
    got, want = to_numpy(got).astype(np.float64), np.asarray(
        want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0
    gap = np.abs(got - want).max()
    assert gap <= tol * scale, (gap, scale)


def _tokens(cfg, seed, shape=(2, SEQ)):
    return rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _pair(cfg_j, cfg, seed=3):
    params_np = _perturb_zeros(
        jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(seed))),
        rng(41))
    return (jax.tree.map(jnp.asarray, params_np),
            interop.lm_params_from_numpy(params_np, cfg, device="cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """One arch's smoke models, parameters, tokens and JAX's results:
    the full logits, the loss and its gradients, the prefill and 8
    greedy tokens after an 8-token prompt."""
    arch = request.param
    cfg_j, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    params_j, params = _pair(cfg_j, cfg)
    jmodel = jbuild(cfg_j)
    toks = _tokens(cfg, 42)
    batch = {"tokens": jnp.asarray(toks)}
    logits, _ = jtfm.lm_forward(cfg_j, params_j, jnp.asarray(toks))
    (loss, met), grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, batch), has_aux=True)(params_j)
    P, n_new = 8, 8
    jcache = jmodel.init_cache(2, P + n_new)
    for t in range(P):
        jl, jcache = jmodel.decode_step(params_j, jcache,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
    tok = jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1)[:, None]
    greedy = [tok]
    for t in range(P, P + n_new - 1):
        jl, jcache = jmodel.decode_step(params_j, jcache, tok, jnp.int32(t))
        tok = jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1)[:, None]
        greedy.append(tok)
    return {"arch": arch, "cfg_j": cfg_j, "cfg": cfg, "params_j": params_j,
            "params": params, "toks": toks, "logits": np.asarray(logits),
            "loss": float(loss), "ce": float(met["ce"]),
            "grads": jax.tree.map(np.asarray, grads),
            "prefill": np.asarray(jmodel.prefill(params_j, batch)),
            "greedy": np.asarray(jnp.concatenate(greedy, axis=1)),
            "prompt": P, "new": n_new}


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copied_field_for_field(arch):
    for port, jax_cfg in ((configs.get_config(arch),
                           jconfigs.get_config(arch)),
                          (configs.get_smoke_config(arch),
                           jconfigs.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
        assert port.hd == jax_cfg.hd and port.pattern == jax_cfg.pattern
    assert arch in configs.list_archs()
    assert configs.get_config(arch).compute_dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_shapes_and_dtypes_match_jax(arch, dtype):
    """The port's own init has JAX's tree (carried across in model
    order), every leaf's shape and dtype, float32 decay leaves in a bf16
    model included, and JAX's parameter count; the zero and one leaves
    are JAX's values."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    want = interop.lm_params_from_numpy(jparams, cfg, device="cpu")
    model = build(cfg, "cpu")
    got = model.init(0)
    wn, wl = tree_flatten_with_names(_sorted(want))
    gn, gl = tree_flatten_with_names(_sorted(got))
    assert gn == wn
    for name, g, w in zip(gn, gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name.endswith(("['D']", "['conv_b']", "['b_a']", "['b_i']",
                          "['scale']", "['norm_scale']")):
            assert torch.equal(g, w), name
        if name.endswith("['A_log']"):        # log(1..H): an ulp apart
            torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
    assert model.param_count(got) == jbuild(cfg_j).param_count(jparams)
    f32 = {"A_log", "dt_bias", "D", "lambda", "b_a", "b_i"}
    for name, g in zip(gn, gl):
        leaf = name.rsplit("['", 1)[1][:-2]
        assert g.dtype == (torch.float32 if leaf in f32
                           else cfg.compute_dtype), name


def _sorted(tree):
    """Dicts with sorted keys, as ``jax.tree`` rebuilds them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(t) for t in tree]
    return tree


def test_init_is_seeded():
    for arch in ARCHS:
        model = build(configs.get_smoke_config(arch), "cpu")
        a, b = model.init(7), model.init(7)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                      tree_leaves(b)))


# ---------------------------------------------------------------------------
# the mixers, layer by layer
# ---------------------------------------------------------------------------

def _ssm_cfgs(n_groups):
    """JAX's and the port's mamba2 smoke configs with ``n_groups``."""
    return tuple(dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, n_groups=n_groups)) for c in (
            jconfigs.get_smoke_config("mamba2-370m"),
            configs.get_smoke_config("mamba2-370m")))


def _rglru_cfgs():
    return (jconfigs.get_smoke_config("recurrentgemma-2b"),
            configs.get_smoke_config("recurrentgemma-2b"))


def _mixer_params(init, cfg_j, seed):
    p = _perturb_zeros(jax.tree.map(np.asarray, init(
        cfg_j, jax.random.PRNGKey(seed))), rng(seed))
    return (jax.tree.map(jnp.asarray, p),
            {k: to_torch(v) for k, v in p.items()})


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_forward_matches_jax(n_groups):
    """Three chunks of 8, the groups broadcast to their heads."""
    cfg_j, cfg = _ssm_cfgs(n_groups)
    pj, pt = _mixer_params(jssm.init_mamba2, cfg_j, 50 + n_groups)
    x = rng(51).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want = jssm.mamba2_forward(cfg_j, pj, jnp.asarray(x))
    _rel(ssm.mamba2_forward(cfg, pt, to_torch(x)), want, 1e-5)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_decode_matches_jax(n_groups):
    """One step from a non-zero cache: the output and both states."""
    cfg_j, cfg = _ssm_cfgs(n_groups)
    pj, pt = _mixer_params(jssm.init_mamba2, cfg_j, 52 + n_groups)
    r = rng(53)
    x = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shapes = jax.tree.map(np.shape, jssm.init_mamba2_cache(cfg_j, 2))
    cache = {k: r.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    want, wcache = jssm.mamba2_decode(
        cfg_j, pj, jnp.asarray(x), {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    port_cache = ssm.init_mamba2_cache(cfg, 2, "cpu")
    for k, v in cache.items():
        port_cache[k].copy_(to_torch(v))
    ptrs = {k: t.data_ptr() for k, t in port_cache.items()}
    got, gcache = ssm.mamba2_decode(cfg, pt, to_torch(x), port_cache)
    _rel(got, want, 1e-5)
    for k in cache:
        assert gcache[k].data_ptr() == ptrs[k]          # written in place
        _rel(gcache[k], wcache[k], 1e-5)


def test_mamba2_decode_ignores_pos_and_equals_forward():
    cfg_j, cfg = _ssm_cfgs(1)
    _, pt = _mixer_params(jssm.init_mamba2, cfg_j, 54)
    x = torch.from_numpy(rng(55).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    full = ssm.mamba2_forward(cfg, pt, x)
    cache = ssm.init_mamba2_cache(cfg, 2, "cpu")
    steps = [ssm.mamba2_decode(cfg, pt, x[:, t:t + 1], cache)[0]
             for t in range(16)]
    _rel(torch.cat(steps, 1), to_numpy(full), DECODE_TOL)


def test_rglru_forward_matches_jax():
    cfg_j, cfg = _rglru_cfgs()
    pj, pt = _mixer_params(jrglru.init_rglru, cfg_j, 60)
    x = rng(61).standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    want = jrglru.rglru_forward(cfg_j, pj, jnp.asarray(x))
    _rel(rglru.rglru_forward(cfg, pt, to_torch(x)), want, 1e-5)


def test_rglru_decode_matches_jax():
    cfg_j, cfg = _rglru_cfgs()
    pj, pt = _mixer_params(jrglru.init_rglru, cfg_j, 62)
    r = rng(63)
    x = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shapes = jax.tree.map(np.shape, jrglru.init_rglru_cache(cfg_j, 2))
    cache = {k: r.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    want, wcache = jrglru.rglru_decode(
        cfg_j, pj, jnp.asarray(x), {k: jnp.asarray(v)
                                    for k, v in cache.items()})
    port_cache = rglru.init_rglru_cache(cfg, 2, "cpu")
    for k, v in cache.items():
        port_cache[k].copy_(to_torch(v))
    got, gcache = rglru.rglru_decode(cfg, pt, to_torch(x), port_cache)
    _rel(got, want, 1e-5)
    for k in cache:
        _rel(gcache[k], wcache[k], 1e-5)


@pytest.mark.parametrize("S", [1, 2, 5, 16, 33])
def test_linear_scan_is_the_recurrence(S):
    """The doubling scan against the step-by-step loop, float32 within
    1e-6 of max|h| (another summation tree)."""
    r = rng(64 + S)
    a = torch.from_numpy(r.uniform(0.5, 1.0, (3, S, 7)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((3, S, 7)).astype(np.float32))
    h, want = torch.zeros(3, 7), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _rel(rglru.linear_scan(a, b), to_numpy(torch.stack(want, 1)), 1e-6)


def test_ring_buffer_decode_matches_jax():
    """``attn_decode(window=8)`` over 16 positions (the ring wraps at 8):
    every step's output and the ring's contents against JAX's, the ring
    of ``min(window, max_len)`` slots, written in place."""
    cfg_j, cfg = _rglru_cfgs()
    pj, pt = _mixer_params(jatt.init_attn, cfg_j, 70)
    x = rng(71).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jcache = jatt.init_cache(cfg_j, 2, 20, window=cfg.window)
    cache = att.init_cache(cfg, 2, 20, "cpu", window=cfg.window)
    assert cache["k"].shape == jcache["k"].shape == (2, 8, 1, 32)
    assert att.init_cache(cfg, 2, 5, "cpu", window=8)["k"].shape[1] == 5
    ptr = cache["k"].data_ptr()
    for t in range(16):
        want, jcache = jatt.attn_decode(cfg_j, pj, jnp.asarray(x[:, t:t + 1]),
                                        jcache, jnp.int32(t),
                                        window=cfg.window)
        got, cache = att.attn_decode(cfg, pt, to_torch(x[:, t:t + 1]), cache,
                                     torch.tensor(t, dtype=torch.int32),
                                     window=cfg.window)
        _rel(got, want, 1e-5)
    assert cache["k"].data_ptr() == ptr
    _rel(cache["k"], jcache["k"], 1e-5)
    _rel(cache["v"], jcache["v"], 1e-5)


def test_ring_buffer_decode_equals_windowed_forward():
    """The port's own oracle: the ring decode against ``attn_full`` with
    the window (``mha``'s banded mask), within 2e-4."""
    cfg_j, cfg = _rglru_cfgs()
    _, pt = _mixer_params(jatt.init_attn, cfg_j, 72)
    x = torch.from_numpy(rng(73).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32))
    pos = torch.arange(20)[None].expand(2, 20)
    full = att.attn_full(cfg, pt, x, pos, causal=True, window=cfg.window)
    cache = att.init_cache(cfg, 2, 20, "cpu", window=cfg.window)
    steps = [att.attn_decode(cfg, pt, x[:, t:t + 1], cache, t,
                             window=cfg.window)[0] for t in range(20)]
    _rel(torch.cat(steps, 1), to_numpy(full), DECODE_TOL)


# ---------------------------------------------------------------------------
# the smoke models end to end
# ---------------------------------------------------------------------------

def test_forward_matches_jax(smoke):
    got = tfm.lm_forward(smoke["cfg"], smoke["params"],
                         to_torch(smoke["toks"]))
    assert got.shape == (2, SEQ, tfm.padded_vocab(smoke["cfg"]))
    _rel(got, smoke["logits"], LOGIT_TOL)


def test_loss_and_gradients_match_jax(smoke):
    """The loss and ce within rtol 1e-5; ``torch.autograd.grad`` of the
    port's loss against ``jax.grad`` of JAX's, every leaf within 1e-4 of
    its max|g|."""
    cfg = smoke["cfg"]
    model = build(cfg, "cpu")
    loss, metrics, grads = train.loss_and_grads(
        model, smoke["params"], {"tokens": to_torch(smoke["toks"])})
    np.testing.assert_allclose(float(loss), smoke["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), smoke["ce"], rtol=1e-5)
    want = interop.lm_params_from_numpy(smoke["grads"], cfg, device="cpu")
    names, wants = tree_flatten_with_names(want)
    got = tree_leaves(grads)
    assert len(got) == len(wants)
    for name, g, w in zip(names, got, wants):
        assert g.dtype == w.dtype, name
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, name


def test_prefill_matches_jax(smoke):
    model = build(smoke["cfg"], "cpu")
    got = model.prefill(smoke["params"], {"tokens": to_torch(smoke["toks"])})
    _rel(got, smoke["prefill"], LOGIT_TOL)


def test_greedy_tokens_match_jax(smoke):
    """The port's ``generate`` (its decode step, captured on the card,
    eager here) against JAX's greedy loop of ``decode_step``: 8 tokens
    after an 8-token prompt, past the ring's 8 slots."""
    model = build(smoke["cfg"], "cpu")
    P, n_new = smoke["prompt"], smoke["new"]
    res = generate(model, smoke["params"],
                   to_torch(smoke["toks"][:, :P]).long(), n_new)
    np.testing.assert_array_equal(to_numpy(res.tokens), smoke["greedy"])


def test_decode_equals_forward(smoke):
    """The port's own oracle: every decode step's logits against the
    full forward within 2e-4."""
    cfg, params = smoke["cfg"], smoke["params"]
    model = build(cfg, "cpu")
    toks = to_torch(smoke["toks"]).long()
    full = tfm.lm_forward(cfg, params, toks)
    cache = model.init_cache(2, SEQ)
    steps = []
    for t in range(SEQ):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    _rel(torch.stack(steps, 1), to_numpy(full), DECODE_TOL)


def test_decode_step_equals_the_eager_decode(smoke):
    """``DecodeStep`` on its static caches (rings and recurrent states
    written in place) against the eager decode in lockstep, bit for bit,
    before and after a reset."""
    cfg, params = smoke["cfg"], smoke["params"]
    model = build(cfg, "cpu")
    toks = to_torch(smoke["toks"]).long()
    P, n = 6, 10
    step = DecodeStep(model, params, 2, P + n)
    for _ in range(2):
        step.reset()
        cache = model.init_cache(2, P + n)
        tok = None
        for t in range(P + n - 1):
            given = toks[:, t:t + 1] if t < P else tok
            logits, cache = model.decode_step(params, cache, given, t)
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            got = step(toks[:, t:t + 1] if t < P else None)
            assert torch.equal(got, logits), t
            assert torch.equal(step.tok, tok), t
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(step.cache), tree_leaves(cache)))


def test_bf16_forward_matches_jax(smoke):
    """bf16 parameters and activations: the logits within 5e-2 of
    max|logit|.  The rounding points are JAX's, but XLA on the CPU
    computes bf16 elementwise chains in float32 and rounds where it
    likes, so single bf16 ulps (2^-8 relative) differ and propagate."""
    arch = smoke["arch"]
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="bfloat16")
    params_j, params = _pair(cfg_j, cfg, seed=4)
    toks = smoke["toks"]
    want, _ = jtfm.lm_forward(cfg_j, params_j, jnp.asarray(toks))
    got = tfm.lm_forward(cfg, params, to_torch(toks))
    assert got.dtype == torch.bfloat16
    _rel(got.float(), np.asarray(want.astype(jnp.float32)), 5e-2)


def test_periodic_pattern_with_a_tail_crosses():
    """(rglru, rglru, local_attn) x 2 + (rglru, rglru): JAX scans a unit
    of mixed kinds twice and unrolls the tail; the port's layers take
    them in model order, and the forward matches."""
    pattern = (cm.RGLRU, cm.RGLRU, cm.LOCAL_ATTN) * 2 + (cm.RGLRU, cm.RGLRU)
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("recurrentgemma-2b"),
                                n_layers=8, block_pattern=pattern)
    cfg = dataclasses.replace(configs.get_smoke_config("recurrentgemma-2b"),
                              n_layers=8, block_pattern=pattern)
    assert cfg_j.scan_groups() == (pattern[:3], 2, pattern[6:])
    params_j, params = _pair(cfg_j, cfg, seed=5)
    assert [sorted(p["mixer"]) for p in params["layers"]][2] == sorted(
        jatt.init_attn(cfg_j, jax.random.PRNGKey(0)))
    toks = _tokens(cfg, 74)
    want, _ = jtfm.lm_forward(cfg_j, params_j, jnp.asarray(toks))
    _rel(tfm.lm_forward(cfg, params, to_torch(toks)), want, LOGIT_TOL)


def test_bf16_interop_keeps_float32_leaves_and_bits():
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("mamba2-370m"),
                                dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config("mamba2-370m"),
                              dtype="bfloat16")
    params_np = jax.tree.map(np.asarray,
                             jbuild(cfg_j).init(jax.random.PRNGKey(9)))
    params = interop.lm_params_from_numpy(params_np, cfg, device="cpu")
    scan = params_np["stack"]["scan"][0]["mixer"]
    for i, layer in enumerate(params["layers"]):
        for name in ("A_log", "dt_bias", "D"):
            assert layer["mixer"][name].dtype == torch.float32
            np.testing.assert_array_equal(layer["mixer"][name].numpy(),
                                          scan[name][i])
        np.testing.assert_array_equal(
            layer["mixer"]["w_in"].view(torch.int16).numpy(),
            scan["w_in"][i].view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_the_smoke_config(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train.main(["--arch", arch, "--smoke", "--steps", "3",
                          "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert res["final_step"] == 3 and res["restarts"] == 0
    assert "done: 3 steps, restarts=0" in out.getvalue()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_smoke_config(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_lm.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "10",
                       "--new-tokens", "4"])
    text = out.getvalue()
    assert f"arch={arch} (smoke config" in text and "decode :" in text
