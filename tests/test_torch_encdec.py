"""The port's encoder-decoder and VLM prefix against the JAX package:
``sinusoidal_pos_emb``, ``cross_cache`` / ``cross_attend``, the encoder,
and the whisper-tiny smoke model end to end (init, forward, loss and its
gradients, prefill, decode step by step after ``encdec_build_cross``,
greedy tokens, the captured decode step, bf16) with JAX's parameters
carried across by ``interop.encdec_params_from_numpy``; the
llava-next-mistral-7b smoke model's prefix path (forward, prefill, loss
and its gradients, greedy tokens) through ``interop.lm_params_from_numpy``;
the launchers' batches and CLIs.  Inputs are made with numpy from a seed;
JAX's results are computed once a module.  JAX's attention is its plain
``mha``; the port's self-attention goes through
``dispatch.flash_attention`` (its plain version on the CPU).

Tolerances (float32): logits within 1e-5 x max|logit| and an encoder's or
a layer's output within 1e-5 of its max|value| (the online softmax over
64-key tiles and the projections sum in another order than XLA's direct
softmax); gradients within 1e-4 x max|g| a leaf; the loss within rtol
1e-5; the port's decode against its forward within 2e-4, the bar of
JAX's own ``tests/test_models.py``; bf16 logits within 5e-2 x
max|logit|, the bar of ``test_torch_recurrent.py``'s bf16 test."""

import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve_lm, train  # noqa: E402
from repro_torch.launch.serve_lm import DecodeStep, generate  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import encdec as ed  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.tree import (tree_flatten_with_names,  # noqa: E402
                              tree_leaves)
from torch_parity import rng, to_numpy, to_torch  # noqa: E402

WHISPER, LLAVA = ARCHS = ("whisper-tiny", "llava-next-mistral-7b")
SEQ = 12
LOGIT_TOL, GRAD_TOL, DECODE_TOL, BF16_TOL = 1e-5, 1e-4, 2e-4, 5e-2


def _perturb_zeros(tree, r):
    """The init's zero leaves (biases, norm offsets) made small and
    random, so that the comparison exercises them."""
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


def _from_numpy(arch, params_np, cfg):
    if arch == WHISPER:
        return interop.encdec_params_from_numpy(params_np, cfg, device="cpu")
    return interop.lm_params_from_numpy(params_np, cfg, device="cpu")


def _pair(arch, dtype="float32", seed=3):
    """JAX's and the port's smoke configs of ``arch`` in ``dtype`` and
    JAX's parameters on both sides."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    params_np = _perturb_zeros(
        jax.tree.map(np.asarray, jbuild(cfg_j).init(jax.random.PRNGKey(seed))),
        rng(41))
    return (cfg_j, cfg, jax.tree.map(jnp.asarray, params_np),
            _from_numpy(arch, params_np, cfg))


def _normal(seed, shape, scale=1.0):
    return (rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _extra(cfg, seed, batch=2):
    """The batch's frames (whisper) or prefix embeddings (llava), numpy."""
    if cfg.encoder is not None:
        return {"frames": _normal(seed, (batch, cfg.encoder.n_ctx,
                                         cfg.d_model))}
    return {"prefix_embeds": _normal(seed, (batch, cfg.n_prefix_embeds,
                                            cfg.d_model), 0.5)}


def _jax_greedy(cfg_j, params_j, toks, frames, P, n_new):
    """JAX's greedy loop of ``decode_step``, as ``examples/serve_lm.py``
    runs it: the cross K/V built first for an encoder-decoder."""
    jmodel = jbuild(cfg_j)
    cache = jmodel.init_cache(toks.shape[0], P + n_new)
    if frames is not None:
        cache = jed.encdec_build_cross(cfg_j, params_j, jnp.asarray(frames),
                                       cache)
    steps = []
    for t in range(P):
        jl, cache = jmodel.decode_step(params_j, cache,
                                       jnp.asarray(toks[:, t:t + 1]),
                                       jnp.int32(t))
        steps.append(np.asarray(jl[:, 0]))
    tok = jnp.argmax(jl[:, -1, :cfg_j.vocab_size], axis=-1)[:, None]
    greedy = [tok]
    for t in range(P, P + n_new - 1):
        jl, cache = jmodel.decode_step(params_j, cache, tok, jnp.int32(t))
        tok = jnp.argmax(jl[:, -1, :cfg_j.vocab_size], axis=-1)[:, None]
        greedy.append(tok)
    return np.stack(steps, 1), np.asarray(jnp.concatenate(greedy, axis=1))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """One arch's smoke models, JAX's parameters on both sides, tokens,
    frames or prefix, and JAX's results: the full logits, the loss and
    its gradients, the prefill, the decode steps' logits over an 8-token
    prompt and 8 greedy tokens after it."""
    arch = request.param
    cfg_j, cfg, params_j, params = _pair(arch)
    jmodel = jbuild(cfg_j)
    toks = rng(42).integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    extra = _extra(cfg, 43)
    batch = {"tokens": jnp.asarray(toks),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    if arch == WHISPER:
        logits = jed.encdec_forward(cfg_j, params_j, batch["tokens"],
                                    batch["frames"])
    else:
        logits, _ = jtfm.lm_forward(cfg_j, params_j, batch["tokens"],
                                    batch["prefix_embeds"])
    (loss, met), grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, batch), has_aux=True)(params_j)
    P, n_new = 8, 8
    steps, greedy = _jax_greedy(cfg_j, params_j, toks, extra.get("frames"),
                                P, n_new)
    return {"arch": arch, "cfg_j": cfg_j, "cfg": cfg, "params_j": params_j,
            "params": params, "toks": toks, "extra": extra,
            "logits": np.asarray(logits), "loss": float(loss),
            "ce": float(met["ce"]), "grads": jax.tree.map(np.asarray, grads),
            "prefill": np.asarray(jmodel.prefill(params_j, batch)),
            "steps": steps, "greedy": greedy, "prompt": P, "new": n_new}


def _batch(smoke, extra=True):
    b = {"tokens": to_torch(smoke["toks"])}
    if extra:
        b.update({k: to_torch(v) for k, v in smoke["extra"].items()})
    return b


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
    assert configs.get_smoke_config(arch).compute_dtype == torch.float32


def _sorted(tree):
    """Dicts with sorted keys, as ``jax.tree`` rebuilds them."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(t) for t in tree]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_shapes_and_dtypes_match_jax(arch, dtype):
    """The port's own init has JAX's tree (carried across in model
    order), every leaf's shape and dtype and JAX's parameter count; the
    norms' ones and zeros and the zero biases are JAX's values."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    jparams = jax.tree.map(np.asarray,
                           jbuild(cfg_j).init(jax.random.PRNGKey(0)))
    want = _from_numpy(arch, jparams, cfg)
    model = build(cfg, "cpu")
    got = model.init(0)
    wn, wl = tree_flatten_with_names(_sorted(want))
    gn, gl = tree_flatten_with_names(_sorted(got))
    assert gn == wn
    for name, g, w in zip(gn, gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.dtype == cfg.compute_dtype, name
        if name.endswith(("['scale']", "['bias']", "['bq']", "['bk']",
                          "['bv']", "['b_up']", "['b_down']")):
            assert torch.equal(g, w), name
    assert model.param_count(got) == jbuild(cfg_j).param_count(jparams)


def test_init_is_seeded():
    for arch in ARCHS:
        model = build(configs.get_smoke_config(arch), "cpu")
        a, b, c = model.init(7), model.init(7), model.init(8)
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))
        assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                         tree_leaves(c)))


def test_interop_keeps_bf16_bits_in_model_order():
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(WHISPER),
                                dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(WHISPER),
                              dtype="bfloat16")
    params_np = jax.tree.map(np.asarray,
                             jbuild(cfg_j).init(jax.random.PRNGKey(9)))
    params = interop.encdec_params_from_numpy(params_np, cfg, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    for side, key in (("encoder", "attn"), ("decoder", "cross_attn")):
        scan = params_np[side]["scan"][key]
        for i, layer in enumerate(params[side]["layers"]):
            np.testing.assert_array_equal(
                layer[key]["wk"].view(torch.int16).numpy(),
                scan["wk"][i].view(np.int16))
    np.testing.assert_array_equal(
        params["pos_emb"].view(torch.int16).numpy(),
        params_np["pos_emb"].view(np.int16))
    with pytest.raises(ValueError, match="layers"):
        interop.encdec_params_from_numpy(params_np, dataclasses.replace(
            cfg, n_layers=3), device="cpu")


# ---------------------------------------------------------------------------
# the pieces: positions, cross-attention, the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pos,d", [(16, 64), (1500, 384)])
def test_sinusoidal_pos_emb_matches_jax(n_pos, d):
    """float32 (n_pos, d), within n_pos x 2^-22 + 2e-6: the frequencies
    agree to an ulp or two (XLA's exp and PyTorch's), which the angle
    p x f carries up to p x 2^-23 before sin and cos add their own."""
    want = np.asarray(jcm.sinusoidal_pos_emb(n_pos, d))
    got = cm.sinusoidal_pos_emb(n_pos, d)
    assert got.dtype == torch.float32 and got.shape == (n_pos, d)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0,
                               atol=n_pos * 2.0 ** -22 + 2e-6)


def _cross_pair(seed=5):
    cfg_j = jconfigs.get_smoke_config(WHISPER)
    cfg = configs.get_smoke_config(WHISPER)
    p_np = _perturb_zeros(jax.tree.map(np.asarray, jatt.init_attn(
        cfg_j, jax.random.PRNGKey(seed))), rng(seed))
    p = {k: to_torch(v) for k, v in p_np.items()}
    return cfg_j, cfg, jax.tree.map(jnp.asarray, p_np), p


def test_cross_cache_and_cross_attend_match_jax():
    """The encoder's K/V with their biases, and 5 queries over its 16
    keys, unmasked."""
    cfg_j, cfg, pj, p = _cross_pair()
    enc_out = _normal(6, (2, cfg.encoder.n_ctx, cfg.d_model))
    x = _normal(7, (2, 5, cfg.d_model))
    want = jatt.cross_cache(cfg_j, pj, jnp.asarray(enc_out))
    got = att.cross_cache(cfg, p, to_torch(enc_out))
    for name in ("k", "v"):
        assert got[name].shape == (2, cfg.encoder.n_ctx, cfg.n_kv_heads,
                                   cfg.hd)
        _rel(got[name], want[name], LOGIT_TOL)
    _rel(att.cross_attend(cfg, p, to_torch(x), got),
         jatt.cross_attend(cfg_j, pj, jnp.asarray(x), want), LOGIT_TOL)


def test_full_self_attention_goes_through_flash(monkeypatch):
    """``attn_full(causal=False)`` without a window hands q, k, v to
    ``dispatch.flash_attention`` with ``causal=False`` (a spy on the
    CPU), and equals JAX's ``attn_full``; cross-attention and a window
    do not reach it."""
    cfg_j, cfg, pj, p = _cross_pair(8)
    calls = []
    real = dispatch.flash_attention

    def spy(q, k, v, *, causal=True):
        calls.append(causal)
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(dispatch, "flash_attention", spy)
    x = _normal(9, (2, 10, cfg.d_model))
    pos = torch.arange(10)[None].expand(2, 10)
    got = att.attn_full(cfg, p, to_torch(x), pos, causal=False)
    assert calls == [False]
    want = jatt.attn_full(cfg_j, pj, jnp.asarray(x),
                          jnp.asarray(pos.numpy()), causal=False)
    _rel(got, want, LOGIT_TOL)
    att.attn_full(cfg, p, to_torch(x), pos, causal=True)
    assert calls == [False, True]
    att.attn_full(cfg, p, to_torch(x), pos, causal=True, window=4)
    att.attn_full(cfg, p, to_torch(x), pos, causal=False,
                  kv_x=to_torch(x[:, :4]), kv_positions=pos[:, :4])
    assert calls == [False, True]


def test_encode_matches_jax_through_the_flash_path(monkeypatch):
    """The encoder's states within 1e-5 of max|value|, one full-attention
    flash call a layer."""
    cfg_j, cfg, params_j, params = _pair(WHISPER, seed=6)
    calls = []
    real = dispatch.flash_attention
    monkeypatch.setattr(dispatch, "flash_attention",
                        lambda q, k, v, *, causal=True: calls.append(causal)
                        or real(q, k, v, causal=causal))
    frames = _normal(10, (3, cfg.encoder.n_ctx, cfg.d_model))
    got = ed.encode(cfg, params["encoder"], to_torch(frames))
    assert calls == [False] * cfg.encoder.n_layers
    _rel(got, jed.encode(cfg_j, params_j["encoder"], jnp.asarray(frames)),
         LOGIT_TOL)


def test_encode_requires_n_ctx_frames():
    cfg = configs.get_smoke_config(WHISPER)
    params = build(cfg, "cpu").init(0)
    with pytest.raises(ValueError, match="frames must be"):
        ed.encode(cfg, params["encoder"],
                  torch.zeros((1, cfg.encoder.n_ctx - 1, cfg.d_model)))


# ---------------------------------------------------------------------------
# the smoke models end to end
# ---------------------------------------------------------------------------

def _forward(smoke):
    cfg, params = smoke["cfg"], smoke["params"]
    b = _batch(smoke)
    if smoke["arch"] == WHISPER:
        return ed.encdec_forward(cfg, params, b["tokens"], b["frames"])
    return tfm.lm_forward(cfg, params, b["tokens"], b["prefix_embeds"])


def test_forward_matches_jax(smoke):
    got = _forward(smoke)
    n_prefix = smoke["cfg"].n_prefix_embeds
    assert got.shape == (2, n_prefix + SEQ, tfm.padded_vocab(smoke["cfg"]))
    _rel(got, smoke["logits"], LOGIT_TOL)


def test_loss_and_gradients_match_jax(smoke):
    """``Model.loss`` (``launch.train.loss_and_grads``): the loss and ce
    within rtol 1e-5, ``torch.autograd.grad`` against ``jax.grad``,
    every leaf within 1e-4 of its max|g|.  A key bias's true gradient is
    0 (it adds q·bk to every score of a query, which the softmax
    ignores): both sides' ``bk`` are rounding noise, held under 1e-6 of
    the largest gradient of the tree instead."""
    cfg = smoke["cfg"]
    model = build(cfg, "cpu")
    loss, metrics, grads = train.loss_and_grads(model, smoke["params"],
                                                _batch(smoke))
    np.testing.assert_allclose(float(loss.detach()), smoke["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), smoke["ce"],
                               rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    want = _from_numpy(smoke["arch"], smoke["grads"], cfg)
    names, wants = tree_flatten_with_names(want)
    got = tree_leaves(grads)
    assert len(got) == len(wants)
    top = max(float(w.abs().max()) for w in wants)
    for name, g, w in zip(names, got, wants):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.endswith("['bk']"):
            assert max(float(g.abs().max()), float(w.abs().max())) <= \
                1e-6 * top, name
            continue
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= GRAD_TOL * scale, name


def test_prefill_matches_jax(smoke):
    model = build(smoke["cfg"], "cpu")
    got = model.prefill(smoke["params"], _batch(smoke))
    assert got.shape == (2, 1, tfm.padded_vocab(smoke["cfg"]))
    _rel(got, smoke["prefill"], LOGIT_TOL)


def _port_steps(smoke, P):
    """The port's eager decode over the prompt: each step's logits."""
    cfg, params = smoke["cfg"], smoke["params"]
    model = build(cfg, "cpu")
    toks = to_torch(smoke["toks"]).long()
    cache = model.init_cache(2, P + smoke["new"])
    if cfg.encoder is not None:
        ed.encdec_build_cross(cfg, params, _batch(smoke)["frames"], cache)
    out = []
    for t in range(P):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        out.append(lg[:, 0])
    return torch.stack(out, 1)


def test_decode_step_by_step_matches_jax(smoke):
    """Each of the prompt's 8 decode steps against JAX's (whisper: after
    ``encdec_build_cross``; llava: tokens only, as JAX decodes)."""
    _rel(_port_steps(smoke, smoke["prompt"]), smoke["steps"], LOGIT_TOL)


def test_greedy_tokens_match_jax(smoke):
    """``generate`` (its step captured on the card, eager here; the
    encoder run once into the step's cross K/V) against JAX's greedy
    loop: 8 tokens after an 8-token prompt, equal."""
    model = build(smoke["cfg"], "cpu")
    P = smoke["prompt"]
    frames = _batch(smoke).get("frames")
    res = generate(model, smoke["params"],
                   to_torch(smoke["toks"][:, :P]).long(), smoke["new"],
                   frames)
    np.testing.assert_array_equal(to_numpy(res.tokens), smoke["greedy"])
    with pytest.raises(ValueError, match="frames"):
        generate(model, smoke["params"],
                 to_torch(smoke["toks"][:, :P]).long(), 2,
                 None if frames is not None else torch.zeros(2, 4, 64))


def test_bf16_forward_matches_jax(smoke):
    """bf16 parameters and activations: the logits within 5e-2 of
    max|logit|.  The rounding points are JAX's, but XLA on the CPU
    computes bf16 elementwise chains in float32 and rounds where it
    likes, and JAX's ``mha`` rounds p to bf16 where the flash path keeps
    it in float32, so single bf16 ulps (2^-8 relative) differ and
    propagate."""
    arch = smoke["arch"]
    cfg_j, cfg, params_j, params = _pair(arch, "bfloat16", seed=4)
    toks = smoke["toks"]
    extra = {k: jnp.asarray(v) for k, v in smoke["extra"].items()}
    if arch == WHISPER:
        want = jed.encdec_forward(cfg_j, params_j, jnp.asarray(toks),
                                  extra["frames"])
        got = ed.encdec_forward(cfg, params, to_torch(toks),
                                to_torch(smoke["extra"]["frames"]))
    else:
        want, _ = jtfm.lm_forward(cfg_j, params_j, jnp.asarray(toks),
                                  extra["prefix_embeds"])
        got = tfm.lm_forward(cfg, params, to_torch(toks),
                             to_torch(smoke["extra"]["prefix_embeds"]))
    assert got.dtype == torch.bfloat16
    _rel(got.float(), np.asarray(want.astype(jnp.float32)), BF16_TOL)


# ---------------------------------------------------------------------------
# the port's own oracles
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper():
    cfg_j, cfg, params_j, params = _pair(WHISPER, seed=7)
    return {"cfg": cfg, "params": params,
            "toks": torch.from_numpy(rng(44).integers(
                0, cfg.vocab_size, (2, SEQ))).long(),
            "frames": to_torch(_normal(45, (2, cfg.encoder.n_ctx,
                                            cfg.d_model)))}


def test_decode_equals_forward(whisper):
    """Every decode step's logits (the cross K/V built once) against the
    full forward within 2e-4; the prefill equals the forward's last
    position."""
    cfg, params, toks = whisper["cfg"], whisper["params"], whisper["toks"]
    model = build(cfg, "cpu")
    full = ed.encdec_forward(cfg, params, toks, whisper["frames"])
    cache = ed.encdec_build_cross(cfg, params, whisper["frames"],
                                  model.init_cache(2, SEQ))
    steps = []
    for t in range(SEQ):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    _rel(torch.stack(steps, 1), to_numpy(full), DECODE_TOL)
    pre = model.prefill(params, {"tokens": toks,
                                 "frames": whisper["frames"]})
    _rel(pre, to_numpy(full[:, -1:]), LOGIT_TOL)


def test_decode_step_equals_the_eager_decode(whisper):
    """``DecodeStep`` on its static caches, the cross K/V built after
    each reset (which zeroes it), against the eager decode in lockstep,
    bit for bit, over two sets of frames."""
    cfg, params, toks = whisper["cfg"], whisper["params"], whisper["toks"]
    model = build(cfg, "cpu")
    P, n = 5, 6
    step = DecodeStep(model, params, 2, P + n)
    for frames in (whisper["frames"], -whisper["frames"]):
        step.reset()
        assert all(not t.any() for t in tree_leaves(step.cache))
        ed.encdec_build_cross(cfg, params, frames, step.cache)
        cache = ed.encdec_build_cross(cfg, params, frames,
                                      model.init_cache(2, P + n))
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


def test_decode_reads_the_position_from_a_tensor(whisper):
    """``pos`` as a 0-dim int32 tensor (the captured step's) and as an int
    give the same logits: ``_dec_embed`` reads the table by
    ``index_select``."""
    cfg, params, toks = whisper["cfg"], whisper["params"], whisper["toks"]
    model = build(cfg, "cpu")
    a = ed.encdec_build_cross(cfg, params, whisper["frames"],
                              model.init_cache(2, 4))
    b = ed.encdec_build_cross(cfg, params, whisper["frames"],
                              model.init_cache(2, 4))
    for t in range(3):
        la, a = model.decode_step(params, a, toks[:, t:t + 1], t)
        lb, b = model.decode_step(params, b, toks[:, t:t + 1],
                                  torch.tensor(t, dtype=torch.int32))
        assert torch.equal(la, lb)


@pytest.fixture(scope="module")
def llava():
    cfg_j, cfg, params_j, params = _pair(LLAVA, seed=8)
    return {"cfg": cfg, "params": params,
            "toks": torch.from_numpy(rng(46).integers(
                0, cfg.vocab_size, (2, SEQ))).long(),
            "prefix": to_torch(_normal(47, (2, cfg.n_prefix_embeds,
                                            cfg.d_model), 0.5))}


def test_embedded_prefix_equals_the_token_prefill(llava):
    """Prefix embeddings that are the embedding table's rows of some
    tokens give the prefill, the forward and the loss of those tokens
    put first, bit for bit: the prefix enters at positions 0 ... P-1."""
    cfg, params, toks = llava["cfg"], llava["params"], llava["toks"]
    model = build(cfg, "cpu")
    head = torch.from_numpy(rng(48).integers(
        0, cfg.vocab_size, (2, cfg.n_prefix_embeds))).long()
    prefix = torch.nn.functional.embedding(head, params["embed"])
    both = torch.cat([head, toks], dim=1)
    assert torch.equal(
        model.prefill(params, {"tokens": toks, "prefix_embeds": prefix}),
        model.prefill(params, {"tokens": both}))
    assert torch.equal(tfm.lm_forward(cfg, params, toks, prefix),
                       tfm.lm_forward(cfg, params, both))


def test_prefix_loss_drops_the_prefix_logits(llava):
    """The loss with a prefix (the hidden states sliced before the head)
    equals the cross entropy of the full logits sliced after it, as JAX
    computes it, within 1e-6 relative."""
    cfg, params, toks = llava["cfg"], llava["params"], llava["toks"]
    loss, met = tfm.lm_loss(cfg, params, {"tokens": toks,
                                          "prefix_embeds": llava["prefix"]})
    logits = tfm.lm_forward(cfg, params, toks, llava["prefix"])
    want = tfm.cross_entropy(logits[:, cfg.n_prefix_embeds:], toks)
    torch.testing.assert_close(met["ce"], want, rtol=1e-6, atol=0)
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)


def test_prefix_prefill_equals_its_forward(llava):
    cfg, params, toks = llava["cfg"], llava["params"], llava["toks"]
    model = build(cfg, "cpu")
    pre = model.prefill(params, {"tokens": toks,
                                 "prefix_embeds": llava["prefix"]})
    full = tfm.lm_forward(cfg, params, toks, llava["prefix"])
    _rel(pre, to_numpy(full[:, -1:]), LOGIT_TOL)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

class _Capture:
    """Stands in for JAX's ``Trainer``: keeps the launcher's batch
    function and runs nothing."""
    batch_fn = None

    def __init__(self, step_fn, state, batch_fn, cfg):
        type(self).batch_fn = batch_fn

    def run(self, steps, callback=None):
        return {"final_step": 0, "restarts": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_fn_matches_jax_launcher(arch, monkeypatch):
    """``launch.train.make_batch_fn`` against the batch function of JAX's
    launcher (``repro/launch/train.py``, its Trainer stubbed): the same
    tokens, and zero frames or prefix embeddings of the same shape and
    dtype."""
    monkeypatch.setattr(jtrain, "Trainer", _Capture)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch, "--smoke",
                                      "--steps", "1", "--batch", "3",
                                      "--seq", "10"])
    with contextlib.redirect_stdout(io.StringIO()):
        jtrain.main()
    cfg = configs.get_smoke_config(arch)
    fn = train.make_batch_fn(cfg, TokenStream(cfg.vocab_size, 3, 10, seed=0,
                                              device="cpu"), 3, 10)
    for step in (0, 5):
        want = _Capture.batch_fn(step)
        got = fn(step)
        assert sorted(got) == sorted(want)
        assert sorted(got) == (["frames", "tokens"] if arch == WHISPER
                               else ["prefix_embeds", "tokens"])
        for k in want:
            np.testing.assert_array_equal(to_numpy(got[k]),
                                          np.asarray(want[k]))
            assert str(got[k].dtype)[6:] == str(want[k].dtype), k


def test_make_batch_fn_of_a_plain_decoder_is_the_stream():
    cfg = configs.get_smoke_config("qwen2-0.5b")
    stream = TokenStream(cfg.vocab_size, 2, 8, seed=1, device="cpu")
    got = train.make_batch_fn(cfg, stream, 2, 8)(3)
    assert list(got) == ["tokens"]
    assert torch.equal(got["tokens"], stream.batch_at(3)["tokens"])


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
                       "--batch", "2", "--prompt-len", "6",
                       "--new-tokens", "4"])
    text = out.getvalue()
    assert f"arch={arch} (smoke config" in text and "decode : 4 tokens" in text
