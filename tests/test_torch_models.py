"""The port's LM serving path against the JAX package: norms, RoPE,
``mha``, the flash kernel's plain version against the Pallas kernel in
interpret mode, and the qwen2-0.5b smoke model end to end (forward,
prefill, decode, greedy tokens) with the JAX model's own parameters
carried across.  Inputs are made with numpy from a seed; the tolerances
are stated beside each test.  The card-only comparisons of the CUDA
kernel are in ``test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_route, bwd_scratch, flash_attention, route)
from repro_torch.launch.serve_lm import generate, main  # noqa: E402
from repro_torch.models import attention as att  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import common as cm  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_parity import rng, to_numpy, to_torch  # noqa: E402

ARCH = "qwen2-0.5b"


def _normal(r, shape, scale=1.0):
    return (r.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_qwen2_config_copied_field_for_field():
    for port, jax_cfg in ((configs.get_config(ARCH), jconfigs.get_config(ARCH)),
                          (configs.get_smoke_config(ARCH),
                           jconfigs.get_smoke_config(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
        assert port.hd == jax_cfg.hd and port.pattern == jax_cfg.pattern
    assert configs.get_config(ARCH).compute_dtype == torch.bfloat16
    assert configs.get_smoke_config(ARCH).compute_dtype == torch.float32
    assert configs.list_archs() == ["phi4-mini-3.8b", "minitron-8b", ARCH,
                                    "qwen1.5-110b", "mamba2-370m",
                                    "recurrentgemma-2b", "whisper-tiny",
                                    "llava-next-mistral-7b",
                                    "qwen3-moe-235b-a22b",
                                    "phi3.5-moe-42b-a6.6b"]
    assert sorted(configs.list_archs()) == sorted(jconfigs.list_archs())


@pytest.mark.parametrize("change", [
    {"block_pattern": (cm.ATTN, cm.LOCAL_ATTN), "window": 4},
    {"block_pattern": (cm.MAMBA2, cm.MAMBA2),
     "ssm": cm.SSMConfig(d_state=16, head_dim=16, chunk=4)},
    {"block_pattern": (cm.RGLRU, cm.ATTN), "rglru": cm.RGLRUConfig()}])
def test_mixed_patterns_build_and_run(change):
    """Local attention, Mamba-2 and RG-LRU layers, alone or beside dense
    attention, build and give finite logits of the padded vocabulary."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **change)
    model = build(cfg, "cpu")
    params = model.init(0)
    assert [sorted(p) for p in params["layers"]] == [
        ["mixer", "norm1"] if kind == cm.MAMBA2
        else ["mixer", "mlp", "norm1", "norm2"] for kind in cfg.pattern]
    logits = model.prefill(params, {"tokens": torch.zeros((2, 8),
                                                          dtype=torch.long)})
    assert logits.shape == (2, 1, tfm.padded_vocab(cfg))
    assert bool(torch.isfinite(logits).all())


def test_build_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(configs.get_smoke_config(ARCH))


# ---------------------------------------------------------------------------
# numerics: atol 1e-6 (float32; pow, cos and sin may differ by an ulp)
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm():
    r = rng(30)
    x, scale, bias = _normal(r, (2, 5, 64), 2.0), _normal(r, (64,), 0.1), \
        _normal(r, (64,), 0.1)
    got = cm.rmsnorm(to_torch(x), to_torch(scale), 1e-6)
    want = jcm.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-6,
                               rtol=0)
    got = cm.layernorm(to_torch(x), to_torch(scale), to_torch(bias), 1e-5)
    want = jcm.layernorm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), 1e-5)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_rmsnorm_keeps_bf16():
    x = torch.randn(3, 64).to(torch.bfloat16)
    assert cm.rmsnorm(x, torch.zeros(64), 1e-6).dtype == torch.bfloat16


@pytest.mark.parametrize("rope_dim", [0, 24])
@pytest.mark.parametrize("base", [1e6, 1e4])
def test_rope_full_and_partial(base, rope_dim):
    r = rng(31)
    x = _normal(r, (2, 64, 3, 32))
    for pos in (np.tile(np.arange(64, dtype=np.int32), (2, 1)),
                r.integers(0, 5000, (2, 64)).astype(np.int32)):
        got = cm.rope(to_torch(x), to_torch(pos), base, rope_dim)
        want = jcm.rope(jnp.asarray(x), jnp.asarray(pos), base, rope_dim)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   atol=1e-6, rtol=0)
    if rope_dim:                 # the channels past rope_dim pass through
        assert np.array_equal(to_numpy(got)[..., rope_dim:],
                              x[..., rope_dim:])


# ---------------------------------------------------------------------------
# mha: atol 1e-5 (float32; another summation order)
# ---------------------------------------------------------------------------

def _qkv(seed, B, Sq, Skv, H, Kh, D):
    r = rng(seed)
    return (_normal(r, (B, Sq, H, D)), _normal(r, (B, Skv, Kh, D)),
            _normal(r, (B, Skv, Kh, D)))


@pytest.mark.parametrize("causal,window,chunk,S", [
    (True, 0, 0, 40),            # direct
    (False, 0, 0, 40),
    (True, 5, 0, 40),            # window
    (True, 0, 16, 40),           # chunked, ragged tail
    (False, 0, 16, 48),
    (True, 7, 16, 40)])
def test_mha_direct_and_chunked(causal, window, chunk, S):
    q, k, v = _qkv(32, 2, S, S, 4, 2, 16)
    got = att.mha(to_torch(q), to_torch(k), to_torch(v), causal=causal,
                  window=window, chunk=chunk)
    want = jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, window=window, chunk=chunk)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("chunk", [0, 8])
def test_mha_decode_with_kv_valid_len(chunk):
    q, k, v = _qkv(33, 2, 1, 24, 6, 2, 16)
    for valid in (1, 7, 24):
        got = att.mha(to_torch(q), to_torch(k), to_torch(v), causal=False,
                      kv_valid_len=valid, chunk=chunk)
        want = jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, kv_valid_len=jnp.int32(valid),
                        chunk=chunk)
        np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                                   atol=1e-5, rtol=0)


def test_mha_equals_the_flash_plain_version_on_the_model_layout():
    """What attn_full sends to the kernel: causal GQA self-attention, held
    within atol 1e-5 of JAX's mha."""
    q, k, v = _qkv(34, 2, 70, 70, 6, 3, 32)
    got = dispatch.flash_attention(to_torch(q), to_torch(k), to_torch(v))
    want = jatt.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# the flash kernel's plain version against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------

def _bhsd(seed, B, H, Kh, S, D):
    r = rng(seed)
    return (_normal(r, (B, H, S, D)), _normal(r, (B, Kh, S, D)),
            _normal(r, (B, Kh, S, D)))


FLASH_SHAPES = [(1, 2, 2, 128, 64),          # MHA
                (2, 4, 2, 256, 64),          # GQA 2:1
                (1, 8, 1, 128, 128)]         # MQA


@pytest.mark.parametrize("B,H,Kh,S,D", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_vs_pallas_interpret(B, H, Kh, S, D, causal):
    """atol 2e-5, the bar of the JAX package's own kernel test."""
    q, k, v = _bhsd(35, B, H, Kh, S, D)
    got = flash_attention(to_torch(q), to_torch(k), to_torch(v),
                          causal=causal)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, block_q=64,
                                block_k=64)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("B,H,Kh,S,D", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_bf16_vs_pallas_interpret(B, H, Kh, S, D, causal):
    """bf16: at least 99.9 % of outputs bit-equal to the Pallas kernel's,
    every one within atol = rtol = 1e-2 (one bf16 ulp).  Both keep p in
    float32 (the TPU kernel upcasts q, k and v before any product), so
    they differ only in float32 summation order, which moves an output
    across a bf16 rounding boundary now and then."""
    q, k, v = (to_torch(a).to(torch.bfloat16)
               for a in _bhsd(36, B, H, Kh, S, D))
    got = flash_attention(q, k, v, causal=causal)
    as_jax = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
              for a in (q, k, v)]
    want = np.asarray(jops.flash_attention(*as_jax, causal=causal,
                                           block_q=64, block_k=64),
                      np.float32)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.mean(got == want) >= 0.999
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("S", [100, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_bf16_is_float32_rounded_once(S, causal):
    """The bf16 plain version equals the float32 plain version of the
    upcast inputs rounded once to bf16, bit for bit (ragged S = 100 and
    S = 128)."""
    q, k, v = (to_torch(a).to(torch.bfloat16)
               for a in _bhsd(39, 2, 4, 2, S, 64))
    got = ref.flash_attention_ref(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 63, 100, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_ragged_vs_jax_ref(S, causal):
    """Any S (JAX's kernel asserts a multiple of its block; its jnp oracle
    does not): atol 2e-5."""
    q, k, v = _bhsd(37, 2, 4, 2, S, 32)
    got = ref.flash_attention_ref(to_torch(q), to_torch(k), to_torch(v),
                                  causal=causal)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_plain_ragged_tail_is_finite_and_reads_strided_views():
    """A ragged last tile (S = 70: tiles of 64 and 6 keys) gives finite
    values, causal or not, and a strided (B, S, H, D) view -- q, k and v
    sliced from one packed tensor -- reads the same values as contiguous
    copies."""
    q, k, v = (to_torch(a) for a in _bhsd(38, 1, 2, 1, 70, 32))
    for causal in (True, False):
        out = ref.flash_attention_ref(q, k, v, causal=causal)
        assert bool(torch.isfinite(out).all())
    packed = torch.cat([q, k, v], dim=1).transpose(1, 2)  # (B, S, 4, D)
    view = packed.transpose(1, 2)
    np.testing.assert_array_equal(
        to_numpy(flash_attention(view[:, :2], view[:, 2:3], view[:, 3:])),
        to_numpy(flash_attention(q, k, v)))


def test_flash_wrapper_rejects_what_it_does_not_take():
    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError):
        flash_attention(q, kv, torch.zeros(1, 2, 9, 32))
    with pytest.raises(ValueError):
        flash_attention(q[0], kv[0], kv[0])
    with pytest.raises(TypeError):
        flash_attention(q, kv.double(), kv)


@pytest.mark.parametrize("dtype,D,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 64, "simt"),
    (torch.float32, 32, "simt")])
def test_flash_route_is_a_rule_on_dtype_and_head_dim(dtype, D, kernel):
    assert route(dtype, D) == kernel


@pytest.mark.parametrize("dtype,D,kernel", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt"), (torch.float32, 32, "simt")])
def test_flash_bwd_route_is_a_rule_on_dtype_and_head_dim(dtype, D, kernel):
    assert bwd_route(dtype, D) == kernel


@pytest.mark.parametrize("kernel,H,Kh,S,D,want", [
    ("wgmma", 14, 2, 2048, 64, (4 * 14 * 2048,
                                4 * 14 * 2048 * (1 + 2 * 64))),
    ("wgmma", 4, 4, 129, 64, (4 * 4 * 192, 4 * 4 * 192)),
    ("wgmma", 4, 2, 129, 128, (4 * 4 * 192,
                               4 * 4 * 192 + 2 * 4 * 4 * 129 * 128)),
    ("mma", 4, 2, 300, 32, (4 * 4 * 300, 0)),
    ("simt", 14, 2, 130, 64, (4 * 14 * 130, 0)),
    # one position, whole and ragged tiles, G = 1 and 7, D = 128
    ("wgmma", 2, 2, 1, 64, (4 * 2 * 64, 4 * 2 * 64)),
    ("wgmma", 2, 1, 1, 128, (4 * 2 * 64, 4 * 2 * 64 + 2 * 4 * 2 * 128)),
    ("wgmma", 4, 4, 64, 128, (4 * 4 * 64, 4 * 4 * 64)),
    ("wgmma", 4, 4, 65, 64, (4 * 4 * 128, 4 * 4 * 128)),
    ("wgmma", 7, 1, 300, 128, (4 * 7 * 320,
                               4 * 7 * 320 + 2 * 4 * 7 * 300 * 128)),
    ("mma", 4, 4, 1, 32, (4 * 4 * 1, 0)),
    ("simt", 8, 2, 2048, 128, (4 * 8 * 2048, 0))])
def test_flash_bwd_scratch_sizes(kernel, H, Kh, S, D, want):
    """delta a row on every route; the wgmma route pads rows to a whole
    64-row tile, keeps lse·log2(e) beside delta and, with a GQA group, the
    float32 partial dK and dV of every query head."""
    assert bwd_scratch(kernel, 4, H, Kh, S, D) == want


def test_cpu_tensors_never_move_the_flash_counter():
    before = flash_attention.launches
    q, k, v = (to_torch(a) for a in _bhsd(40, 1, 2, 1, 16, 32))
    flash_attention(q, k, v)
    model = build(configs.get_smoke_config(ARCH), "cpu")
    model.prefill(model.init(0), {"tokens": torch.zeros((1, 5),
                                                        dtype=torch.long)})
    assert flash_attention.launches == before


# ---------------------------------------------------------------------------
# the qwen2 smoke model end to end, with JAX's parameters carried across:
# atol 2e-4, the bar of tests/test_models.py's decode-vs-forward test
# ---------------------------------------------------------------------------

def _perturb_zeros(tree, r):
    """The init's zero leaves (biases, norm scales) made small and random,
    so that the comparison exercises them."""
    def f(a):
        a = np.asarray(a)
        if not a.any():
            return (r.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree.map(f, tree)


@pytest.fixture(scope="module")
def qwen_pair():
    cfg_j = jconfigs.get_smoke_config(ARCH)
    params_np = _perturb_zeros(jbuild(cfg_j).init(jax.random.PRNGKey(3)),
                               rng(41))
    params_j = jax.tree.map(jnp.asarray, params_np)
    cfg = configs.get_smoke_config(ARCH)
    params = interop.lm_params_from_numpy(params_np, cfg, device="cpu")
    toks = rng(42).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return cfg_j, params_j, cfg, params, toks


def test_forward_and_prefill_match_jax(qwen_pair):
    cfg_j, params_j, cfg, params, toks = qwen_pair
    want, _ = jtfm.lm_forward(cfg_j, params_j, jnp.asarray(toks))
    got = tfm.lm_forward(cfg, params, to_torch(toks))
    assert got.shape == want.shape == (2, 12, tfm.padded_vocab(cfg))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    model = build(cfg, "cpu")
    pre = model.prefill(params, {"tokens": to_torch(toks)})
    want_pre = jbuild(cfg_j).prefill(params_j, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(to_numpy(pre), np.asarray(want_pre),
                               atol=2e-4, rtol=2e-4)


def test_decode_and_greedy_tokens_match_jax(qwen_pair):
    """8 decode steps' logits within 2e-4, then 8 greedy tokens equal (the
    port's ``generate`` against JAX's serve loop, float32)."""
    cfg_j, params_j, cfg, params, toks = qwen_pair
    jmodel, model = jbuild(cfg_j), build(cfg, "cpu")
    P, n_new = 8, 8
    jcache = jmodel.init_cache(2, P + n_new)
    cache = model.init_cache(2, P + n_new)
    for t in range(P):
        jl, jcache = jmodel.decode_step(params_j, jcache,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
        pl, cache = model.decode_step(params, cache,
                                      to_torch(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(to_numpy(pl), np.asarray(jl), atol=2e-4,
                                   rtol=2e-4)
    # JAX's greedy loop, as examples/serve_lm.py runs it
    jcache = jmodel.init_cache(2, P + n_new)
    for t in range(P):
        jl, jcache = jmodel.decode_step(params_j, jcache,
                                        jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
    tok = jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1)[:, None]
    want = [tok]
    for t in range(P, P + n_new - 1):
        jl, jcache = jmodel.decode_step(params_j, jcache, tok, jnp.int32(t))
        tok = jnp.argmax(jl[:, -1, :cfg.vocab_size], axis=-1)[:, None]
        want.append(tok)
    res = generate(model, params, to_torch(toks[:, :P]).long(), n_new)
    assert res.tokens.shape == (2, n_new)
    np.testing.assert_array_equal(to_numpy(res.tokens),
                                  np.asarray(jnp.concatenate(want, axis=1)))


def test_port_decode_matches_port_forward():
    """The port's own oracle: the cache path equals the full forward (the
    flash path) within 2e-4, on the port's own random init."""
    cfg = configs.get_smoke_config(ARCH)
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(5))
    toks = torch.randint(0, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(6))
    full = tfm.lm_forward(cfg, params, toks)
    cache = model.init_cache(2, 10)
    steps = []
    for t in range(10):
        lg, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    np.testing.assert_allclose(to_numpy(torch.stack(steps, dim=1)),
                               to_numpy(full), atol=2e-4, rtol=2e-4)
    pre = model.prefill(params, {"tokens": toks})
    np.testing.assert_allclose(to_numpy(pre), to_numpy(full[:, -1:]),
                               atol=2e-4, rtol=2e-4)
    with dispatch.use_kernels(False):
        twin = model.prefill(params, {"tokens": toks})
    assert torch.equal(pre, twin)


def test_init_is_seeded_and_counts_params():
    cfg = configs.get_smoke_config(ARCH)
    model = build(cfg, "cpu")
    a, b = model.init(7), model.init(7)
    assert all(torch.equal(x, y) for x, y in zip(
        tfm_leaves(a), tfm_leaves(b)))
    jparams = jbuild(jconfigs.get_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0))
    assert model.param_count(a) == jbuild(
        jconfigs.get_smoke_config(ARCH)).param_count(jparams)
    assert a["layers"][0]["mixer"]["wq"].shape == (64, 2, 32)
    assert a["layers"][0]["mixer"]["wo"].shape == (2, 32, 64)


def tfm_leaves(tree):
    from repro_torch.models.model_api import _leaves
    return list(_leaves(tree))


def test_interop_keeps_bf16_bits():
    """A bf16 JAX init crosses with every bit kept and every dtype
    bfloat16, and its layers arrive in model order."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(ARCH),
                                dtype="bfloat16")
    params_np = jax.tree.map(np.asarray,
                             jbuild(cfg_j).init(jax.random.PRNGKey(9)))
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              dtype="bfloat16")
    params = interop.lm_params_from_numpy(params_np, cfg, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tfm_leaves(params))
    scan = params_np["stack"]["scan"][0]
    for i, layer in enumerate(params["layers"]):
        for name in ("wq", "wk", "wv", "wo", "bq"):
            np.testing.assert_array_equal(
                layer["mixer"][name].view(torch.int16).numpy(),
                scan["mixer"][name][i].view(np.int16))
    np.testing.assert_array_equal(params["embed"].view(torch.int16).numpy(),
                                  params_np["embed"].view(np.int16))
    with pytest.raises(ValueError, match="layers"):
        interop.lm_params_from_numpy(params_np, dataclasses.replace(
            cfg, n_layers=3), device="cpu")


def test_serve_lm_cli_on_the_cpu(capsys):
    main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "4",
          "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "smoke config" in out and "decode : 3 tokens x 2 seqs" in out
