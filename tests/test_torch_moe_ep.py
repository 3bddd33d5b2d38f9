"""The expert-parallel branch of the port's ``moe_ffn`` on a 2-rank gloo
world against JAX's ``shard_map`` branch on 2 forced CPU devices and
against the port's one-rank ``moe_ffn``, at both MoE smoke configs in
float32 (phi3.5-moe: 4 experts, top 2; qwen3-moe: 8 experts, top 2).

Each rank holds half the experts (``launch.shardings`` places the
weights over ``model``), routes every token with the whole router,
runs its experts and the partial outputs are summed.  In float32 a
token's output is one or two products added to zero, in either order,
so the outputs are expected equal to the bit; they are held at 1e-6 of
max|y| (rtol 1e-6), aux at rtol 1e-6, the gradients at 1e-5 of their
largest entry.  The worlds run in subprocesses (``torch_mesh_ref``), so
no process group outlives the test."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ref as ref  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    jax_out = ref.run_jax("jax_ep_main", str(tmp / "jax.pkl"), devices=2)
    ranks = ref.run_world("ep_scenario", 2, str(tmp / "world"))
    return jax_out, ranks


def _one_rank(arch: str) -> dict:
    """The port's ``moe_ffn`` with no rules: all experts here."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    inp = ref.ep_inputs(arch)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in
         inp["p"].items()}
    x = torch.from_numpy(inp["x"]).requires_grad_()
    with moe.log_routes() as routes:
        y, aux = moe.moe_ffn(cfg, p, x)
    grads = torch.autograd.grad(
        (y * torch.from_numpy(inp["ct"])).sum() + aux,
        [p[k] for k in sorted(p)] + [x])
    return {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
            "gp": {k: g.numpy() for k, g in zip(sorted(p), grads)},
            "gx": grads[-1].numpy(), "topi": [t.numpy() for t, _ in routes],
            "kept": [k.numpy() for _, k in routes]}


def _close(a, b, rel: float) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=rel * max(float(np.abs(b).max()), 1e-30))


@pytest.mark.parametrize("arch", ref.EP_ARCHS)
def test_expert_shards_are_halves(worlds, arch):
    """Each rank holds E / 2 experts of every expert weight."""
    _, ranks = worlds
    cfg = get_smoke_config(arch)
    for r in ranks:
        assert r[arch]["w_gate_local"] == (cfg.moe.n_experts // 2,
                                           cfg.d_model, cfg.moe.d_ff)


@pytest.mark.parametrize("arch", ref.EP_ARCHS)
def test_ranks_agree_and_route_as_one_rank(worlds, arch):
    """Both ranks return the same whole outputs, and every rank routes
    the tokens as the one-rank ``moe_ffn`` does (routes equal, kept
    pairs of its own experts only)."""
    _, ranks = worlds
    one = _one_rank(arch)
    for key in ("y", "aux", "gx"):
        np.testing.assert_array_equal(ranks[0][arch][key],
                                      ranks[1][arch][key])
    E = get_smoke_config(arch).moe.n_experts
    for rank, r in enumerate(ranks):
        (topi,), (kept,) = r[arch]["topi"], r[arch]["kept"]
        np.testing.assert_array_equal(topi, one["topi"][0])
        local = (topi >= rank * E // 2) & (topi < (rank + 1) * E // 2)
        np.testing.assert_array_equal(kept, one["kept"][0] & local)


@pytest.mark.parametrize("arch", ref.EP_ARCHS)
def test_expert_parallel_matches_one_rank(worlds, arch):
    """y at 1e-6 of max|y|, aux at 1e-6, gradients at 1e-5 of their
    largest entry, against the port's one-rank ``moe_ffn``."""
    _, ranks = worlds
    one, ep = _one_rank(arch), ranks[0][arch]
    _close(ep["y"], one["y"], 1e-6)
    _close(ep["aux"], one["aux"], 1e-6)
    _close(ep["gx"], one["gx"], 1e-5)
    for k in one["gp"]:
        _close(ep["gp"][k], one["gp"][k], 1e-5)


@pytest.mark.parametrize("arch", ref.EP_ARCHS)
def test_expert_parallel_matches_jax_shard_map(worlds, arch):
    """The port's branch against JAX's ``shard_map`` branch on a (1, 2)
    mesh, and JAX's branch against its own one-device ``moe_ffn``: y at
    1e-6 of max|y|, aux at 1e-6, gradients at 1e-5."""
    jax_out, ranks = worlds
    ep, jep, jone = ranks[0][arch], jax_out[(arch, True)], \
        jax_out[(arch, False)]
    _close(ep["y"], jep["y"], 1e-6)
    _close(ep["aux"], jep["aux"], 1e-6)
    _close(jep["y"], jone["y"], 1e-6)
    _close(ep["gx"], jep["gx"], 1e-5)
    for k in ep["gp"]:
        _close(ep["gp"][k], jep["gp"][k], 1e-5)
