"""The port's LM training path against the JAX package: ``cross_entropy``,
``Model.loss`` and its gradients at the smoke configs of the four dense
decoders, three AdamW steps of ``launch.train.make_step_fn`` against
JAX's jitted step, the attention's plain backward against autograd of
the plain forward, bf16 checkpoints (round trip, JAX's bytes, JAX's
checkpoints restored), a resumed ``Trainer`` run and the CLI.  Inputs are
made with numpy from a seed and JAX's parameters are carried across by
``interop.lm_params_from_numpy``; the tolerances are stated beside each
test.  The card-only cases (the backward kernel) are in
``test_torch_cuda.py``."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import (tree_flatten_with_names,  # noqa: E402
                              tree_leaves, tree_map)
from torch_parity import assert_bits_equal, rng, to_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen2-0.5b", "phi4-mini-3.8b", "minitron-8b", "qwen1.5-110b")
LR = 3e-4


def _perturb_zeros(tree, r):
    """The init's zero leaves (biases, norm scales) made small and random,
    so that the comparison exercises their gradients."""
    def f(a):
        a = np.asarray(a)
        if not a.any():
            return (r.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a
    return jax.tree.map(f, tree)


def _pair(arch: str, dtype: str = "float32", seed: int = 3):
    """JAX's model and parameters and the port's, the same numbers."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=dtype)
    params_np = _perturb_zeros(jbuild(cfg_j).init(jax.random.PRNGKey(seed)),
                               rng(41))
    return (jbuild(cfg_j), jax.tree.map(jnp.asarray, params_np),
            build(cfg, "cpu"), interop.lm_params_from_numpy(
                params_np, cfg, device="cpu"))


def _tokens(vocab: int, seed: int, shape=(2, 24)) -> np.ndarray:
    return rng(seed).integers(0, vocab, shape).astype(np.int32)


def _port_grads(model, params, tokens):
    loss, metrics, grads = train.loss_and_grads(
        model, params, {"tokens": torch.from_numpy(tokens)})
    return loss, metrics, tree_leaves(grads)


# ---------------------------------------------------------------------------
# configs (A18.1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dense_config_copied_field_for_field(arch):
    for port, jax_cfg in ((configs.get_config(arch),
                           jconfigs.get_config(arch)),
                          (configs.get_smoke_config(arch),
                           jconfigs.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
        assert port.hd == jax_cfg.hd and port.pattern == jax_cfg.pattern
    assert arch in configs.list_archs()
    assert configs.get_config(arch).compute_dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the loss: rtol 1e-5 in float32 (XLA's and PyTorch's logsumexp and sums)
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_jax():
    r = rng(60)
    logits = (r.standard_normal((3, 17, 384)) * 4).astype(np.float32)
    toks = r.integers(0, 384, (3, 17)).astype(np.int32)
    got = tfm.cross_entropy(torch.from_numpy(logits), torch.from_numpy(toks))
    want = jtfm.cross_entropy(jnp.asarray(logits), jnp.asarray(toks))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_cross_entropy_of_bf16_logits_is_float32():
    r = rng(61)
    logits = torch.from_numpy(r.standard_normal((2, 9, 256)).astype(
        np.float32)).to(torch.bfloat16)
    toks = torch.from_numpy(r.integers(0, 256, (2, 9)).astype(np.int32))
    got = tfm.cross_entropy(logits, toks)
    want = jtfm.cross_entropy(jnp.asarray(logits.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(toks.numpy()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    """The full logits within 2e-4 (tests/test_torch_models.py's bar) and
    the loss, ce and aux within rtol 1e-5."""
    jmodel, params_j, model, params = _pair(arch)
    toks = _tokens(model.cfg.vocab_size, 62)
    logits = tfm.lm_forward(model.cfg, params, torch.from_numpy(toks))
    want, _ = jtfm.lm_forward(jmodel.cfg, params_j, jnp.asarray(toks))
    np.testing.assert_allclose(to_numpy(logits), np.asarray(want),
                               atol=2e-4, rtol=2e-4)
    loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks)})
    jloss, jmet = jmodel.loss(params_j, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmet["ce"]),
                               rtol=1e-5)
    assert metrics["aux"].dtype == torch.float32 and float(
        metrics["aux"]) == float(jmet["aux"]) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(arch):
    """torch.autograd.grad of the port's loss against jax.grad of JAX's,
    every leaf within 1e-4 of its max|g| (float32: the flash plain
    forward and backward against JAX's direct softmax; tied embeddings
    sum their two uses, partial RoPE and D = 16 / 32 included)."""
    jmodel, params_j, model, params = _pair(arch)
    toks = _tokens(model.cfg.vocab_size, 63)
    _, _, grads = _port_grads(model, params, toks)
    jgrads = jax.grad(lambda p: jmodel.loss(
        p, {"tokens": jnp.asarray(toks)})[0])(params_j)
    want = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jgrads),
                                        model.cfg, device="cpu")
    names, wants = tree_flatten_with_names(want)
    assert len(grads) == len(wants)
    for name, g, w in zip(names, grads, wants):
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= 1e-4 * scale, name


# ---------------------------------------------------------------------------
# three AdamW steps against JAX's jitted step_fn (repro/launch/train.py)
# ---------------------------------------------------------------------------

def _jax_step(jmodel, opt):
    @jax.jit
    def step_fn(state, batch):
        (loss, met), grads = jax.value_and_grad(
            lambda p: jmodel.loss(p, batch), has_aux=True)(state["params"])
        new_p, new_o = opt.update(grads, state["opt"], state["params"])
        return {"params": new_p, "opt": new_o}, {"loss": loss, **met}
    return step_fn


# float32: losses within rtol 1e-5, the update (master - init) within
# relative L2 1e-3 of JAX's and every master element within LR / 3 (AdamW
# divides by sqrt(v): where |g| is as small as the 1e-6-relative gradient
# gaps, the normalised step differs; 7.1e-5 measured).  bf16: losses
# within rtol 2e-3 and the update within relative L2 0.15 (JAX's bf16
# attention rounds p to bf16 before p.v, the port's flash path keeps it in
# float32: gradient leaves differ by up to 3 % of their max; 0.072-0.079
# measured)
STEP_BARS = {"float32": dict(loss_rtol=1e-5, update_l2=1e-3, elem=LR / 3),
             "bfloat16": dict(loss_rtol=2e-3, update_l2=0.15, elem=None)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_adamw_steps_match_jax(dtype):
    jmodel, params_j, model, params = _pair("qwen2-0.5b", dtype)
    bars = STEP_BARS[dtype]
    jopt, opt = jadamw(LR), adamw(LR)
    jstep, step = _jax_step(jmodel, jopt), train.make_step_fn(model, opt)
    jstate = {"params": params_j, "opt": jopt.init(params_j)}
    state = {"params": params, "opt": opt.init(params)}
    init = [p.float() for p in tree_leaves(params)]
    for i in range(3):
        toks = _tokens(model.cfg.vocab_size, 70 + i)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, met = step(state, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                                   rtol=bars["loss_rtol"])
    assert int(state["opt"].step) == 3
    assert all(p.dtype == model.cfg.compute_dtype
               for p in tree_leaves(state["params"]))
    master = tree_leaves(state["opt"].inner["master"])
    jmaster = tree_leaves(interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, jstate["opt"].inner["master"]),
        dataclasses.replace(model.cfg, dtype="float32"), device="cpu"))
    du = torch.cat([(m - p0).flatten() for m, p0 in zip(master, init)])
    dj = torch.cat([(m - p0).flatten() for m, p0 in zip(jmaster, init)])
    assert float((du - dj).norm() / dj.norm()) <= bars["update_l2"]
    if bars["elem"] is not None:
        assert float((du - dj).abs().max()) <= bars["elem"]
    # the bf16 params are the master rounded once
    for p, m in zip(tree_leaves(state["params"]), master):
        assert torch.equal(p, m.to(p.dtype))


def test_step_moves_no_launch_counter_on_the_cpu():
    model = build(configs.get_smoke_config("qwen2-0.5b"), "cpu")
    opt = adamw(LR)
    state = train.make_state(model, opt)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    state, met = train.make_step_fn(model, opt)(
        state, {"tokens": torch.from_numpy(_tokens(256, 80))})
    assert bool(torch.isfinite(met["loss"]))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


def test_step_leaves_its_input_state_unchanged():
    model = build(configs.get_smoke_config("qwen2-0.5b"), "cpu")
    opt = adamw(LR)
    state = train.make_state(model, opt)
    copy = tree_map(torch.clone, state)
    train.make_step_fn(model, opt)(
        state, {"tokens": torch.from_numpy(_tokens(256, 81))})
    for a, b in zip(tree_leaves(state), tree_leaves(copy)):
        assert torch.equal(a, b) and not a.requires_grad


# ---------------------------------------------------------------------------
# the attention's plain backward against autograd of the plain forward:
# float32 within 1e-5 of max|grad| (sum order), bf16 within 1e-2 (the
# output rounded to bf16 enters delta; autograd keeps it in float32);
# max|grad| over dq, dk and dv (at S = 1 dq is 0 up to rounding)
# ---------------------------------------------------------------------------

# (B, H, Kh, S, D, causal): D = 32, 64, 128; G = 1, 2, 7; causal and full;
# ragged S (no multiple of 64) and one position
BWD_GRID = [(2, 2, 2, 70, 32, True), (1, 4, 2, 130, 64, False),
            (1, 7, 1, 65, 128, True), (2, 14, 2, 100, 64, True),
            (1, 2, 1, 1, 32, True), (1, 6, 3, 96, 128, False)]
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _bwd_inputs(B, H, Kh, S, D, dtype, seed):
    r = rng(seed)
    q, k, v, do = (torch.from_numpy(r.standard_normal(s).astype(np.float32)
                                    ).to(dtype)
                   for s in ((B, H, S, D), (B, Kh, S, D), (B, Kh, S, D),
                             (B, H, S, D)))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Kh,S,D,causal", BWD_GRID)
def test_plain_backward_matches_autograd(B, H, Kh, S, D, causal, dtype):
    q, k, v, do = _bwd_inputs(B, H, Kh, S, D, dtype, 90 + S)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, causal=causal)
    want = torch.autograd.grad(o, leaves, do)
    o2, lse = ref.flash_attention_ref(q, k, v, causal=causal,
                                      return_lse=True)
    assert torch.equal(o2, o.detach()) and lse.dtype == torch.float32
    assert lse.shape == (B, H, S)
    got = ref.flash_attention_bwd_ref(q, k, v, o2, do, lse, causal=causal)
    scale = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * scale


def test_flash_wrappers_take_the_plain_versions_on_the_cpu():
    q, k, v, do = _bwd_inputs(2, 4, 2, 70, 32, torch.float32, 95)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    o, lse = flash_attention(q, k, v, return_lse=True)
    assert torch.equal(o, ref.flash_attention_ref(q, k, v))
    got = flash_attention_bwd(q, k, v, o, do, lse)
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (flash_attention.launches, flash_attention_bwd.launches) == before
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, do, lse[..., :-1])


def test_dispatch_records_the_function_only_under_autograd():
    """Without grad the call is the forward alone; with it, FlashAttention,
    whose gradient is the plain backward's (kernels on or off, on the
    CPU)."""
    r = rng(96)
    q, k, v = (torch.from_numpy(r.standard_normal((2, 40, h, 32)).astype(
        np.float32)) for h in (4, 2, 2))
    out = dispatch.flash_attention(q, k, v)
    assert out.grad_fn is None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = dispatch.flash_attention(*leaves)
    assert type(out.grad_fn).__name__ == "TransposeBackward0"
    do = torch.from_numpy(r.standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, leaves, do)
    o, lse = ref.flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                                     return_lse=True)
    want = ref.flash_attention_bwd_ref(
        *(t.transpose(1, 2) for t in (q, k, v)), o, do.transpose(1, 2), lse)
    for g, w in zip(got, want):
        assert torch.equal(g, w.transpose(1, 2))
    with dispatch.use_kernels(False):
        again = torch.autograd.grad(dispatch.flash_attention(*leaves),
                                    leaves, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# ---------------------------------------------------------------------------
# bf16 checkpoints: bit for bit, JAX's bytes
# ---------------------------------------------------------------------------

def _lm_state_np(seed: int = 0) -> dict:
    """An LM training state's shape in numpy: bf16 params (a dict with a
    list of layers), the float32 master and moments, the step."""
    r = rng(seed)
    bf = lambda s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"embed": bf((16, 8)), "layers": [{"w": bf((8, 8)), "b": bf(8)},
                                             {"w": bf((8, 8)), "b": bf(8)}]}


def _port_state(params_np):
    params = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                      params_np)
    opt = adamw(LR).init(params)
    return {"params": params, "opt": opt._replace(step=opt.step + 7)}


def _jax_state(params_np):
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                          params_np)
    opt = jadamw(LR).init(params)
    return {"params": params, "opt": opt._replace(step=opt.step + 7)}


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    state = _port_state(_lm_state_np())
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, state)
    template = tree_map(torch.zeros_like, state)
    out, _ = mgr.restore(5, template)
    for a, b in zip(tree_leaves(out), tree_leaves(state)):
        assert a.dtype == b.dtype
        assert_bits_equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                          else a, b.view(torch.int16)
                          if b.dtype == torch.bfloat16 else b)


def test_bf16_npz_equals_what_jax_writes(tmp_path):
    """The port's arrays.npz holds the arrays JAX's manager writes for the
    same state: the same names, dtypes (bf16 as V2) and bytes, and the
    manifests name the leaves alike."""
    params_np = _lm_state_np(1)
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(
        0, _port_state(params_np))
    JManager(str(tmp_path / "jax"), async_save=False).save(
        0, _jax_state(params_np))
    got = np.load(tmp_path / "port" / "step_0000000000" / "arrays.npz")
    want = np.load(tmp_path / "jax" / "step_0000000000" / "arrays.npz")
    assert sorted(got.files) == sorted(want.files)
    assert np.dtype("V2") in {got[n].dtype for n in got.files}
    for name in want.files:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        assert got[name].tobytes() == want[name].tobytes(), name
    import json
    names = [json.load(open(tmp_path / d / "step_0000000000" /
                            "manifest.json"))["names"]
             for d in ("port", "jax")]
    assert names[0] == names[1]


def test_port_restores_a_jax_written_bf16_checkpoint(tmp_path):
    params_np = _lm_state_np(2)
    JManager(str(tmp_path), async_save=False).save(3, _jax_state(params_np))
    want = _port_state(params_np)
    out, _ = CheckpointManager(str(tmp_path)).restore(
        3, tree_map(torch.zeros_like, want))
    for a, b in zip(tree_leaves(out), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_v2_leaf_into_a_float_template_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"w": torch.ones(3, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="bf16"):
        mgr.restore(0, {"w": torch.zeros(3)})


# ---------------------------------------------------------------------------
# the Trainer: a resumed LM run equals a straight one, bit for bit
# ---------------------------------------------------------------------------

def _lm_trainer(model, ckpt_dir=None):
    opt = adamw(LR)
    stream = TokenStream(model.cfg.vocab_size, 2, 16, seed=4, device="cpu")
    return Trainer(train.make_step_fn(model, opt),
                   train.make_state(model, opt, seed=5),
                   train.make_batch_fn(model.cfg, stream, 2, 16),
                   TrainerConfig(ckpt_dir=ckpt_dir, log_every=2))


def test_resumed_lm_run_equals_a_straight_run(tmp_path):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-0.5b"),
                              dtype="bfloat16")
    model = build(cfg, "cpu")
    straight = _lm_trainer(model)
    out = straight.run(6)
    assert out["final_step"] == 6 and out["restarts"] == 0
    first = _lm_trainer(model, str(tmp_path))
    first.run(3)
    resumed = _lm_trainer(model, str(tmp_path))
    assert resumed.start_step == 3
    resumed.run(3)
    leaves = tree_leaves(resumed.state)
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    for a, b in zip(leaves, tree_leaves(straight.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in straight.history][3:]


def test_make_batch_fn_checks_the_stream():
    cfg = configs.get_smoke_config("qwen2-0.5b")
    stream = TokenStream(cfg.vocab_size, 2, 16, seed=0, device="cpu")
    fn = train.make_batch_fn(cfg, stream, 2, 16)
    assert torch.equal(fn(7)["tokens"], fn(7)["tokens"])
    with pytest.raises(ValueError):
        train.make_batch_fn(cfg, stream, 4, 16)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_the_smoke_config_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-0.5b", "--smoke", "--steps", "3", "--batch", "2", "--seq",
         "32", "--device", "cpu"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("step 0: loss=")
    assert lines[-1] == "done: 3 steps, restarts=0"


@pytest.mark.parametrize("flag", ["--production-mesh", "--multi-pod"])
def test_train_cli_mesh_flags_raise_naming_their_items(flag):
    """Outside a launcher's world of 256 (512) ranks the production mesh
    raises naming both sizes and leaves no process group behind; a
    checkpoint directory on a mesh raises naming item 12b."""
    import torch.distributed as dist

    need = "512" if flag == "--multi-pod" else "256"
    with pytest.raises(ValueError, match=f"{need} ranks.*has 1"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                    flag])
    assert not dist.is_initialized()
    with pytest.raises(NotImplementedError, match="12b"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                    flag, "--ckpt-dir", "unused"])


def test_train_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps", "1"])
