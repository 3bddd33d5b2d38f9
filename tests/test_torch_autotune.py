"""The port's kernel block-shape autotuner (``repro_torch.tuning.
autotune``) on the CPU: JAX's ``tests/test_autotune.py`` cases that
still apply (buckets, keys, a stored entry that wins, the clamp, a
missing or corrupt file, racing writers in subprocesses, the repointed
variable and the reset), the key format and the symbolic entries against
JAX's own functions, the card's heuristic against the layouts the
kernels had before tuning, refused candidates, and dispatch through a
table against the plain path."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.tuning import autotune as jat  # noqa: E402
from repro_torch.kernels import autotune as shim  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import fxp_matmul as fxp_mod  # noqa: E402
from repro_torch.kernels import kmeans_assign as km_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import split_hist as sh_mod  # noqa: E402
from repro_torch.tuning import autotune as at  # noqa: E402
from repro_torch.tuning.measurement import Measurement  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_torch  # noqa: E402

H100 = "cuda:NVIDIA H100 80GB HBM3"
SMS = 132


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", path)
    at.reset_cache_for_tests()
    yield path
    at.reset_cache_for_tests()


class TestBuckets:
    def test_shape_bucket_pow2(self):
        assert at.shape_bucket((300, 130, 70)) == (512, 256, 128)
        assert at.shape_bucket((1, 128)) == (1, 128)

    @pytest.mark.parametrize("shape", [(300, 130, 70), (1, 128),
                                       (256, 65536, 64, 1), (3, 5, 7, 9),
                                       (1, 1, 1), (65537, 2, 1000)])
    def test_bucket_and_key_equal_to_jax(self, shape):
        """The same bucket and the same ``kernel|dtype|bucket|backend``
        string as JAX's functions on the same shape."""
        assert at.shape_bucket(shape) == jat.shape_bucket(shape)
        for kernel, tdt, jdt in (("fxp_matmul", torch.int8, jnp.int8),
                                 ("kmeans_assign", torch.float32,
                                  jnp.float32),
                                 ("split_hist", torch.uint8, jnp.uint8)):
            assert at.table_key(kernel, tdt, shape, "cpu") == \
                jat.table_key(kernel, jdt, shape, "cpu")
            assert at.table_key(kernel, "int16", shape, "tpu") == \
                jat.table_key(kernel, "int16", shape, "tpu")

    def test_nearby_shapes_share_keys(self):
        k1 = at.table_key("fxp_matmul", torch.int8, (3, 300, 130, 70), "cpu")
        k2 = at.table_key("fxp_matmul", torch.int8, (4, 400, 200, 100), "cpu")
        assert k1 == k2

    def test_backend_in_key(self):
        k_cpu = at.table_key("fxp_matmul", torch.int8, (1, 64, 64, 8), "cpu")
        k_card = at.table_key("fxp_matmul", torch.int8, (1, 64, 64, 8), H100)
        assert k_cpu != k_card and k_card.endswith("|" + H100)

    def test_lanes_in_key(self):
        assert at.table_key("kmeans_assign", torch.int16, (8, 65536, 16, 8),
                            "cpu") != at.table_key(
            "kmeans_assign", torch.int16, (256, 65536, 16, 8), "cpu")

    def test_backend_of_the_cpu(self):
        assert at.backend_of(torch.device("cpu")) == "cpu"
        assert at.backend_of("cpu") == "cpu"


class TestSymbolicEntries:
    @pytest.mark.parametrize("entry", [
        {"block_n": "N"}, {"block_n": ["heur", 2]}, {"block_n": ["heur", 0.5]},
        {"block_n": ["heur", 0.25]}, {"block_n": 512}, {"block_n": 0}])
    def test_resolve_entry_as_jax(self, entry):
        """A dim name takes that dim's extent, ``["heur", f]`` scales the
        heuristic, an int is literal, as JAX resolves them (the port's
        shape has the lanes in front)."""
        for kernel in ("kmeans_assign", "split_hist"):
            heur = {"block_n": 1000}
            jshape = (3000, 16, 8)
            got = at._resolve_entry(kernel, entry, heur, (7,) + jshape)
            assert got == jat._resolve_entry(kernel, entry, heur, jshape)

    def test_resolve_fxp_entry_as_jax(self):
        heur = {"block_m": 2048, "block_n": 16}
        entry = {"block_m": ["heur", 0.125], "block_n": "N"}
        got = at._resolve_entry("fxp_matmul", entry, heur, (2, 300, 64, 10))
        want = jat._resolve_entry("fxp_matmul", entry, heur, (300, 64, 10))
        assert got == want == {"block_m": 256, "block_n": 10}


class TestHeuristics:
    def test_card_heuristic_at_the_main_paths_shapes(self):
        """At 132 SMs the card's heuristic gives the launch arguments the
        kernels had before tuning: fxp_matmul 8 row groups a block (2,048
        int8 rows, 32 blocks a lane at 65,536 rows) by 16 columns;
        kmeans_assign int16 at K = 8, D = 16: 4,096 rows a block (16 a
        lane); split_hist at uint8 bins: the whole lane at every level."""
        fxp = at.block_shapes("fxp_matmul", torch.int8, (256, 65536, 64, 1),
                              H100, sms=SMS)
        assert fxp == {"block_m": 2048, "block_n": 16}
        assert -(-65536 // fxp["block_m"]) == 32
        assert at.block_shapes("fxp_matmul", torch.int16, (256, 65536, 64, 1),
                               H100, sms=SMS)["block_m"] == 1024
        km = at.block_shapes("kmeans_assign", torch.int16, (256, 65536, 16, 8),
                             H100, sms=SMS)
        assert km == {"block_n": 4096}
        assert km_mod.grid_blocks(65536, 8, 16, km["block_n"]) == (4096, 16)
        for level in range(7):
            nodes = 2 ** level
            sh = at.block_shapes("split_hist", torch.uint8,
                                 (256, 65536, 16, nodes * 32 * 4), H100,
                                 sms=SMS, n_nodes=nodes)
            assert sh == {"block_n": 65536}

    @pytest.mark.parametrize("L,R,D,K", [(256, 65536, 16, 8), (3, 1001, 5, 3),
                                         (2, 777, 33, 17), (256, 2000, 16, 8),
                                         (1, 4099, 16, 64), (16, 1024, 16, 8),
                                         (128, 65536, 16, 8)])
    def test_card_heuristic_is_the_kmeans_grid(self, L, R, D, K):
        """The grid at the heuristic's block_n is the one ``max_blocks``
        gave the source: rows a block and blocks a lane."""
        bn = at.block_shapes("kmeans_assign", torch.float32, (L, R, D, K),
                             H100, sms=SMS)["block_n"]
        blocks = km_mod.max_blocks(L, R, K, D, SMS)
        tile = km_mod.layout(K, D)["tile"]
        rows = -(-(-(-R // blocks)) // tile) * tile
        assert km_mod.grid_blocks(R, K, D, bn) == (rows, -(-R // rows))

    @pytest.mark.parametrize("L,R,F,nodes,bins,classes", [
        (256, 65536, 16, 1, 32, 4), (256, 65536, 16, 64, 32, 4),
        (4, 65536, 16, 1, 32, 4), (4, 65536, 16, 64, 32, 4),
        (3, 1001, 7, 3, 9, 5), (2, 5000, 40, 96, 16, 3),
        (160, 3001, 40, 96, 16, 3), (3, 100003, 16, 16, 32, 4),
        (128, 65536, 16, 8, 32, 4), (1, 2 ** 24, 16, 32, 32, 4)])
    def test_card_heuristic_is_the_split_hist_layout(self, L, R, F, nodes,
                                                     bins, classes):
        """``split_hist.layout`` at the heuristic's block_n is the layout
        its own rule chose before tuning, bulk or not."""
        bn = at.block_shapes("split_hist", torch.uint8,
                             (L, R, F, nodes * bins * classes), H100,
                             sms=SMS, n_nodes=nodes)["block_n"]
        assert sh_mod.layout(L, R, F, nodes, bins, classes, SMS, bn) == \
            sh_mod.layout(L, R, F, nodes, bins, classes, SMS)

    @pytest.mark.parametrize("dtype,M", [(torch.int8, 65536),
                                         (torch.int8, 1000),
                                         (torch.int16, 65536),
                                         (torch.int16, 77)])
    def test_card_heuristic_is_the_fxp_rows_grid(self, dtype, M):
        """``blocks_m`` of the source, ``ceil(M / (8 groups))``, at the
        heuristic's block_m."""
        bm = at.block_shapes("fxp_matmul", dtype, (3, M, 64, 4), H100,
                             sms=SMS)["block_m"]
        rows = fxp_mod.group_rows(dtype)
        assert bm % rows == 0
        assert -(-M // bm) == -(-M // (fxp_mod.ROW_GROUPS * rows)) or \
            bm == -(-M // rows) * rows

    def test_cpu_heuristic_is_one_block(self):
        """The CPU's plain versions take no blocks; its heuristic takes
        each extent whole, rounded to the kernel's unit, as JAX's
        interpret heuristic collapses a small problem into one block."""
        assert at.block_shapes("fxp_matmul", torch.int8, (1, 64, 128, 32),
                               "cpu") == {"block_m": 256, "block_n": 16}
        assert at.block_shapes("kmeans_assign", torch.float32,
                               (1, 5000, 16, 8), "cpu") == {"block_n": 5120}
        assert at.block_shapes("split_hist", torch.uint8, (2, 5000, 16, 64),
                               "cpu") == {"block_n": 5000}

    def test_card_heuristic_needs_the_sm_count_off_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device gives the SM count")
        with pytest.raises(ValueError, match="SM count"):
            at.block_shapes("kmeans_assign", torch.float32, (1, 100, 4, 3),
                            H100)

    def test_blocks_never_exceed_the_shape_rounded_to_the_unit(self):
        for backend in ("cpu", H100):
            b = at.block_shapes("fxp_matmul", torch.int8, (1, 3, 5, 2),
                                backend, sms=SMS)
            assert b["block_m"] == 256 and b["block_n"] in (8, 16)
            b = at.block_shapes("kmeans_assign", torch.float32,
                                (1, 3, 5, 2), backend, sms=SMS)
            assert b["block_n"] == km_mod.layout(2, 5)["tile"]
            b = at.block_shapes("split_hist", torch.uint8, (1, 3, 5, 2),
                                backend, sms=SMS)
            assert b["block_n"] <= 3

    def test_unknown_kernel(self):
        with pytest.raises(ValueError, match="unknown kernel"):
            at.block_shapes("flash_attention", torch.bfloat16, (1, 2, 3, 4),
                            "cpu")


class TestCandidates:
    def test_hopper_rows_at_the_main_paths_shapes(self):
        """fxp_matmul: 1, 2, 4, 8, 16 row groups by 8 or 16 columns, the
        heuristic first; kmeans_assign: a quarter to four times the
        heuristic and one block a lane; split_hist: the whole lane and
        16,384, 4,096, 1,024 rows."""
        fxp = at._candidates("fxp_matmul", torch.int8, (256, 65536, 64, 1),
                             H100, sms=SMS)
        assert fxp[0] == {"block_m": 2048, "block_n": 16} and len(fxp) == 10
        assert {c["block_m"] for c in fxp} == {256, 512, 1024, 2048, 4096}
        assert {c["block_n"] for c in fxp} == {8, 16}
        km = at._candidates("kmeans_assign", torch.int16, (256, 65536, 16, 8),
                            H100, sms=SMS)
        assert [c["block_n"] for c in km] == [4096, 1024, 2048, 8192, 16384,
                                              65536]
        for nodes in (1, 8, 32):
            sh = at._candidates("split_hist", torch.uint8,
                                (256, 65536, 16, nodes * 128), H100,
                                sms=SMS, n_nodes=nodes)
            assert [c["block_n"] for c in sh] == [65536, 16384, 4096, 1024]

    def test_clamped_and_deduplicated(self):
        """The gradient's dot (M = 64) collapses every block_m to one row
        group; K-means' tiles round small rows up, and duplicates go."""
        grad = at._candidates("fxp_matmul", torch.int8, (256, 64, 65536, 1),
                              H100, sms=SMS)
        assert grad == [{"block_m": 256, "block_n": 16},
                        {"block_m": 256, "block_n": 8}]
        km = at._candidates("kmeans_assign", torch.float32, (2, 300, 4, 3),
                            H100, sms=SMS)
        assert km == [{"block_n": 256}, {"block_n": 512}]

    def test_refused_candidates_are_named(self, monkeypatch):
        """A block_n the kernel does not take, and row chunks past the
        grid's 65,535, are left out and reported, not launched."""
        monkeypatch.setitem(at.CANDIDATE_TABLE, "fxp_matmul", {
            "default": ({"block_m": 256, "block_n": 12},
                        {"block_m": 512, "block_n": 8})})
        monkeypatch.setitem(at.CANDIDATE_TABLE, "split_hist", {
            "default": ({"block_n": 1}, {"block_n": 1024})})
        refused = []
        fxp = at._candidates("fxp_matmul", torch.int8, (2, 1000, 64, 4), H100,
                             sms=SMS, refused=refused)
        assert {"block_m": 256, "block_n": 12} not in fxp
        sh = at._candidates("split_hist", torch.uint8, (1, 2 ** 20, 16, 4),
                            H100, sms=SMS, refused=refused)
        assert {"block_n": 1} not in sh and {"block_n": 1024} in sh
        assert [(c, "block_n" in why or "65535" in why)
                for c, why in refused] == [
            ({"block_m": 256, "block_n": 12}, True), ({"block_n": 1}, True)]

    def test_register_candidates_for_a_card(self, monkeypatch):
        monkeypatch.setitem(at.CANDIDATE_TABLE, "kmeans_assign",
                            dict(at.CANDIDATE_TABLE["kmeans_assign"]))
        at.register_candidates("kmeans_assign", [{"block_n": 256}],
                               backend=H100)
        got = at._candidates("kmeans_assign", torch.int16, (256, 65536, 16, 8),
                             H100, sms=SMS)
        assert got == [{"block_n": 4096}, {"block_n": 256}]
        other = at._candidates("kmeans_assign", torch.int16,
                               (256, 65536, 16, 8), "cuda:another card",
                               sms=SMS)
        assert len(other) == 6
        with pytest.raises(ValueError, match="unknown kernel"):
            at.register_candidates("nope", [])

    def test_sweep_checks_every_candidate_and_refuses_in_the_open(
            self, tmp_cache, monkeypatch):
        monkeypatch.setitem(at.CANDIDATE_TABLE, "split_hist", {
            "default": ({"block_n": "N"}, {"block_n": 100}, {"block_n": 0.5})})
        seen = []
        sweep = at.measure_candidates(
            "split_hist", (2, 1000, 5, 2 * 9 * 3), torch.uint8,
            hist=(2, 9, 3), check=lambda blocks, out: seen.append(
                (blocks, tuple(out.shape))))
        assert [m.key[2] for m in sweep.measured] == [
            (("block_n", 1000),), (("block_n", 100),), (("block_n", 1),)]
        assert seen == [({"block_n": n}, (2, 2, 5, 9, 3))
                        for n in (1000, 100, 1)]
        assert sweep.refused == []
        for m in sweep.measured:
            assert isinstance(m, Measurement) and m.source == "autotune"
            assert m.steps == 1 and m.seconds > 0
            assert m.key[1] == at.table_key("split_hist", torch.uint8,
                                            (2, 1000, 5, 54), "cpu")


class TestMeasuredCache:
    def test_autotune_persists_and_wins(self, tmp_cache):
        best = at.autotune("fxp_matmul", (1, 64, 128, 32))
        with open(tmp_cache) as f:
            data = json.load(f)
        assert data["version"] == 1 and len(data["entries"]) == 1
        (key, entry), = data["entries"].items()
        assert key == "fxp_matmul|int8|1x64x128x32|cpu"
        assert entry["blocks"] == best
        at.reset_cache_for_tests()
        assert at.block_shapes("fxp_matmul", torch.int8,
                               (1, 64, 128, 32), "cpu") == best

    def test_measured_entry_wins_over_the_heuristic(self, tmp_cache):
        key = at.table_key("kmeans_assign", torch.int16, (256, 65536, 16, 8),
                           H100)
        at._store(key, {"block_n": 1024}, 1.0)
        assert at.block_shapes("kmeans_assign", torch.int16,
                               (256, 65536, 16, 8), H100, sms=SMS) == \
            {"block_n": 1024}
        assert at.block_shapes("kmeans_assign", torch.int16,
                               (256, 65536, 16, 8), "cuda:another card",
                               sms=SMS) == {"block_n": 4096}

    def test_measured_entry_clamped_to_smaller_call(self, tmp_cache):
        """An entry stored at a bucket's larger shape is clamped to a
        smaller call of the bucket, then rounded to the kernel's unit."""
        at._store(at.table_key("kmeans_assign", torch.float32,
                               (1, 500, 120, 30), "cpu"),
                  {"block_n": 1024}, 1.0)
        b = at.block_shapes("kmeans_assign", torch.float32, (1, 300, 100, 20),
                            "cpu")
        tile = km_mod.layout(20, 100)["tile"]
        assert b == {"block_n": -(-300 // tile) * tile}
        at._store(at.table_key("fxp_matmul", torch.int8, (1, 500, 120, 30),
                               "cpu"), {"block_m": 4096, "block_n": 8}, 1.0)
        b = at.block_shapes("fxp_matmul", torch.int8, (1, 300, 100, 20),
                            "cpu")
        assert b == {"block_m": 512, "block_n": 8}

    def test_entry_the_kernel_refuses_is_passed_over(self, tmp_cache):
        at._store(at.table_key("fxp_matmul", torch.int8, (1, 64, 64, 4),
                               "cpu"), {"block_m": 256, "block_n": 12}, 1.0)
        assert at.block_shapes("fxp_matmul", torch.int8, (1, 64, 64, 4),
                               "cpu") == {"block_m": 256, "block_n": 16}

    def test_missing_cache_file_falls_back(self, tmp_cache):
        b = at.block_shapes("kmeans_assign", torch.float32, (1, 100, 4, 3),
                            "cpu")
        assert b["block_n"] == km_mod.layout(3, 4)["tile"]

    def test_corrupt_cache_ignored(self, tmp_cache):
        with open(tmp_cache, "w") as f:
            f.write("{not json")
        at.reset_cache_for_tests()
        b = at.block_shapes("fxp_matmul", torch.int8, (1, 8, 8, 8), "cpu")
        assert b["block_m"] == 256

    def test_autotune_kmeans_smoke(self, tmp_cache):
        best = at.autotune("kmeans_assign", (1, 256, 8, 4))
        assert 1 <= best["block_n"] <= 256

    def test_fresh_process_store_merges_disk_entries(self, tmp_cache):
        at._store("other|int8|64x64x64|cpu", {"block_n": 8}, 1.0)
        at.reset_cache_for_tests()
        at.autotune("kmeans_assign", (1, 64, 4, 2))
        with open(tmp_cache) as f:
            entries = json.load(f)["entries"]
        assert "other|int8|64x64x64|cpu" in entries
        assert any(k.startswith("kmeans_assign|") for k in entries)

    def test_shim_shares_the_cache(self, tmp_cache):
        assert shim.block_shapes is at.block_shapes
        assert shim._load_cache is at._load_cache
        shim._store("x|int8|1x1x1x1|cpu", {"block_n": 1}, 1.0)
        assert "x|int8|1x1x1x1|cpu" in at._load_cache()

    def test_default_path_is_the_ports_own(self, monkeypatch, tmp_path):
        monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path))
        assert at.cache_path() == str(tmp_path / ".cache" / "repro_torch" /
                                      "autotune_blocks.json")
        assert at.cache_path() != jat.cache_path()


_RACE_WORKER = r"""
import json, sys
from repro_torch.tuning import autotune as at

wid, iters = sys.argv[1], int(sys.argv[2])
for i in range(iters):
    at.reset_cache_for_tests()
    at._store(f"race{wid}k{i}|int8|1x64x64x64|cpu",
              {"block_m": 256, "block_n": 8}, float(i))
with open(at.cache_path()) as f:
    assert isinstance(json.load(f)["entries"], dict)
print("ok")
"""


class TestConcurrentWriters:
    """Two processes racing ``$REPRO_TORCH_AUTOTUNE_CACHE`` never leave a
    torn file (a temp file per writer, then ``os.replace``)."""

    def _spawn(self, tmp_cache, wid, iters):
        env = dict(os.environ, REPRO_TORCH_AUTOTUNE_CACHE=tmp_cache,
                   PYTHONPATH=os.path.join(os.path.dirname(__file__),
                                           os.pardir, "src"))
        return subprocess.Popen(
            [sys.executable, "-c", _RACE_WORKER, wid, str(iters)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)

    def test_racing_writers_never_corrupt_json(self, tmp_cache):
        procs = [self._spawn(tmp_cache, "A", 30),
                 self._spawn(tmp_cache, "B", 30)]
        while any(p.poll() is None for p in procs):
            try:
                with open(tmp_cache) as f:
                    assert isinstance(json.load(f).get("entries"), dict)
            except FileNotFoundError:
                pass
            time.sleep(0.01)
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{err}"
            assert "ok" in out
        with open(tmp_cache) as f:
            entries = json.load(f)["entries"]
        assert entries
        for key, entry in entries.items():
            assert key.startswith("race"), key
            assert set(entry["blocks"]) == {"block_m", "block_n"}
        leftovers = [f for f in os.listdir(os.path.dirname(tmp_cache))
                     if f.endswith(".tmp")]
        assert leftovers == []

    def test_sequential_processes_merge_entries(self, tmp_cache):
        a = self._spawn(tmp_cache, "A", 2)
        assert a.wait(timeout=120) == 0, a.communicate()[1]
        b = self._spawn(tmp_cache, "B", 2)
        assert b.wait(timeout=120) == 0, b.communicate()[1]
        with open(tmp_cache) as f:
            entries = json.load(f)["entries"]
        assert "raceAk1|int8|1x64x64x64|cpu" in entries
        assert "raceBk1|int8|1x64x64x64|cpu" in entries


class TestResetIsolation:
    def test_env_repoint_is_keyed_without_reset(self, tmp_cache, tmp_path,
                                                monkeypatch):
        key = at.table_key("kmeans_assign", torch.float32, (1, 600, 16, 8),
                           "cpu")
        at._store(key, {"block_n": 256}, 1.0)
        assert at.block_shapes("kmeans_assign", torch.float32,
                               (1, 600, 16, 8), "cpu") == {"block_n": 256}
        monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                           str(tmp_path / "other_cache.json"))
        assert at.block_shapes("kmeans_assign", torch.float32,
                               (1, 600, 16, 8), "cpu") == {"block_n": 768}

    def test_same_path_mutation_needs_reset(self, tmp_cache):
        key = at.table_key("kmeans_assign", torch.float32, (1, 600, 16, 8),
                           "cpu")
        at.block_shapes("kmeans_assign", torch.float32, (1, 600, 16, 8),
                        "cpu")
        with open(tmp_cache, "w") as f:
            json.dump({"version": 1, "entries": {key: {
                "blocks": {"block_n": 256}, "us": 1.0}}}, f)
        stale = at.block_shapes("kmeans_assign", torch.float32,
                                (1, 600, 16, 8), "cpu")
        assert stale == {"block_n": 768}
        at.reset_cache_for_tests()
        assert at.block_shapes("kmeans_assign", torch.float32,
                               (1, 600, 16, 8), "cpu") == {"block_n": 256}

    def test_store_after_reset_does_not_resurrect_memory(self, tmp_cache):
        at._store("ghost|int8|8x8x8x8|cpu", {"block_n": 8}, 1.0)
        os.remove(tmp_cache)
        at.reset_cache_for_tests()
        at._store("real|int8|8x8x8x8|cpu", {"block_n": 16}, 1.0)
        with open(tmp_cache) as f:
            entries = json.load(f)["entries"]
        assert set(entries) == {"real|int8|8x8x8x8|cpu"}


def _ints(r, shape, dtype):
    info = np.iinfo(dtype)
    return to_torch(r.integers(info.min, info.max + 1, shape).astype(dtype))


class TestDispatchThroughATable:
    """Dispatch asks the table at every call, and what a table entry
    sets reaches the wrapper in a form it takes; the result equals the
    plain path (``use_kernels(False)``)."""

    def _table(self, tmp_cache):
        at._store(at.table_key("fxp_matmul", torch.int16, (3, 47, 83, 11),
                               "cpu"), {"block_m": 128, "block_n": 8}, 1.0)
        at._store(at.table_key("kmeans_assign", torch.int16,
                               (3, 1001, 5, 4), "cpu"), {"block_n": 300}, 1.0)
        at._store(at.table_key("split_hist", torch.uint8, (3, 1001, 7, 60),
                               "cpu"), {"block_n": 100}, 1.0)

    def test_dispatch_parity_with_table(self, tmp_cache, monkeypatch):
        self._table(tmp_cache)
        r = rng(2)
        calls = []
        real = {"fxp": fxp_mod.fxp_matmul, "km": km_mod.kmeans_assign,
                "sh": sh_mod.split_hist}

        def spy(name):
            def call(*args, **kw):
                calls.append((name, {k: v for k, v in kw.items()
                                     if k.startswith("block")}))
                return real[name](*args, **kw)
            return call

        monkeypatch.setattr(fxp_mod, "fxp_matmul", spy("fxp"))
        monkeypatch.setattr(dispatch._km, "kmeans_assign", spy("km"))
        monkeypatch.setattr(dispatch._sh, "split_hist", spy("sh"))

        a = _ints(r, (3, 47, 83), np.int16)
        b = _ints(r, (83, 11), np.int16)
        x = _ints(r, (3, 1001, 5), np.int16)
        scale = to_torch(r.uniform(1e-4, 1e-3, 5).astype(np.float32))
        c = to_torch(r.standard_normal((4, 5)).astype(np.float32) * 5)
        w = to_torch((r.random((3, 1001)) < 0.9).astype(np.float32))
        node = to_torch(r.integers(0, 3, (3, 1001)).astype(np.int32))
        xbin = to_torch(r.integers(0, 5, (3, 1001, 7)).astype(np.uint8))
        y = to_torch(r.integers(0, 4, (3, 1001)).astype(np.int32))

        def run():
            return (dispatch.hybrid_matmul(a, b),
                    dispatch.kmeans_partials(x, c, w, scale),
                    dispatch.level_histogram(node, xbin, y, w, n_nodes=3,
                                             n_bins=5, n_classes=4))

        got = run()
        assert calls == [("fxp", {"block_m": 128, "block_n": 8}),
                         ("fxp", {"block_m": 128, "block_n": 8}),
                         ("km", {"block_n": 512}),
                         ("sh", {"block_n": 100})]
        with dispatch.use_kernels(False):
            want = run()
        assert_bits_equal(got[0], want[0])
        for g, w_ in zip(got[1], want[1]):
            np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-5,
                                       atol=1e-5)
        assert_bits_equal(got[2], want[2])

    def test_hybrid_launches_by_block_n(self):
        assert dispatch.hybrid_launches(10) == 1
        assert dispatch.hybrid_launches(10, block_n=8) == 2
        assert dispatch.fxp_shape(torch.zeros(3, 5, 7, dtype=torch.int8),
                                  torch.zeros(7, 2, dtype=torch.int8)) == \
            (3, 5, 7, 2)


class TestWrapperBlocks:
    """The wrappers' block arguments: what they take and refuse, and the
    plain version they run on the CPU, whatever the blocks."""

    def test_fxp_block_checks(self):
        a = torch.zeros(2, 40, 64, dtype=torch.int8)
        b = torch.zeros(64, 10, dtype=torch.int16)
        with pytest.raises(ValueError, match="block_n"):
            fxp_mod.fxp_matmul(a, b[:, :8], block_n=12)
        with pytest.raises(ValueError, match="columns"):
            fxp_mod.fxp_matmul(a, b, block_n=8)
        with pytest.raises(ValueError, match="multiple of 256"):
            fxp_mod.fxp_matmul(a, b, block_m=128)
        with pytest.raises(TypeError, match="int8 a and b"):
            fxp_mod.fxp_matmul(a, b, out_dtype=torch.int32)
        assert fxp_mod.grouped(a, b, block_m=512, block_n=8).shape == \
            (2, 40, 10)

    def test_fxp_int32_output_is_the_int32_product(self):
        r = rng(5)
        a = _ints(r, (33, 9000), np.int8)
        b = _ints(r, (9000, 19), np.int8)
        got = fxp_mod.grouped(a, b, block_n=8, out_dtype=torch.int32)
        want = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
        assert torch.equal(got, ref.fxp_matmul_int32_ref(a, b))

    def test_split_hist_layout_by_block_n(self):
        whole = sh_mod.layout(4, 65536, 16, 1, 32, 4, SMS, 65536)
        assert not whole["bulk"] and whole["chunks"] == 1
        bulk = sh_mod.layout(256, 65536, 16, 1, 32, 4, SMS, 4096)
        assert bulk["bulk"] and bulk["chunks"] == 16
        with pytest.raises(ValueError, match="65535"):
            sh_mod.layout(1, 2 ** 20, 16, 1, 32, 4, SMS, 8)

    def test_kmeans_grid_by_block_n(self):
        assert km_mod.grid_blocks(65536, 8, 16, 4096) == (4096, 16)
        assert km_mod.grid_blocks(65536, 8, 16, 100) == (256, 256)
        assert km_mod.grid_blocks(1000, 8, 16, 768) == (512, 2)
        assert km_mod.grid_blocks(1000, 8, 16, 10 ** 6) == (1024, 1)
        with pytest.raises(ValueError, match="block_n"):
            km_mod.kmeans_assign(torch.zeros(1, 4, 2), torch.zeros(1, 2),
                                 torch.ones(1, 4), block_n=0)
