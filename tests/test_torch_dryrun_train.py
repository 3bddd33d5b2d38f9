"""The port's dry run of every arch's training step (``launch.dryrun``),
its smoke config at batch 8 × 64 on a fake (2, 2) ``("data", "model")``
mesh, and qwen2-0.5b's on a fake (2, 2, 2) ``("pod", "data", "model")``
one: ``Model.loss``, ``torch.autograd.grad``, the gradients pinned to the
parameters' placements and AdamW's update, all on ``DTensor``s of fake
tensors, each cell ``OK`` with its collectives counted.  Apart from
``test_torch_dryrun.py`` so that the two spread over test workers; each
fake world lives inside its call (``dryrun.fake_mesh``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ARCHS = tuple(configs.list_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_cell_ok(arch):
    r = dryrun.run_cell(arch, "train_4k", cfg=configs.get_smoke_config(arch),
                        mesh_shape=(2, 2), mesh_names=("data", "model"),
                        batch=8, seq_len=64)
    assert r["status"] == "OK", r.get("trace")
    # a step reduces gradients over the data axis and gathers shards
    assert r["collectives"]["all-gather"]["count"] > 0
    assert r["cost_analysis"]["flops"] > 0
    assert r["memory"]["temp_bytes"] > 0


def test_train_cell_on_pods():
    r = dryrun.run_cell("qwen2-0.5b", "train_4k",
                        cfg=configs.get_smoke_config("qwen2-0.5b"),
                        mesh_shape=(2, 2, 2),
                        mesh_names=("pod", "data", "model"), batch=8,
                        seq_len=64)
    assert r["status"] == "OK", r.get("trace")
    assert r["mesh"] == "pod2x2x2" and r["n_chips"] == 8


@pytest.mark.parametrize("module", ["repro_torch.distributed.sharding",
                                    "repro_torch.tree"])
def test_doc_examples(module):
    """The modules' examples (the sharding module's starts and ends a
    world of one process)."""
    import doctest
    import importlib
    failed, tried = doctest.testmod(importlib.import_module(module))
    assert tried > 0 and failed == 0
