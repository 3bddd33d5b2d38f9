"""Port parity of the data pipeline's pieces (``repro_torch.data.pipeline``
and ``core.quantize.quantize_fixed_scale``): the port's counterparts of
``tests/test_pipeline.py`` and the pieces of ``tests/test_streaming.py``
below a fit.

Against the JAX package, bit for bit on the same numpy inputs: the fixed
scale quantization (numpy and torch, exact .5 ties included), the global
absmax statistics, a rotation window's host arrays (``shuffle=False``,
and ``shuffle=True`` with JAX's permutation injected), the token stream
and the rotation's tag.  The port alone: the Prefetcher's lifecycle
(every wait bounded: a hang would cost the suite), a worker's exception
raised by the consumer, window shapes and placement, epoch coverage, the
pad rows, the schedule cache and the feed a trainer reads.
"""

import doctest
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import make_cpu_grid as jax_grid  # noqa: E402
from repro.core import quantize as jqz  # noqa: E402
from repro.core.mlalgos import LinReg as JLinReg  # noqa: E402
from repro.data import StreamingDataset as JStreamingDataset  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro_torch.core import make_cpu_grid  # noqa: E402
from repro_torch.core import quantize as qz  # noqa: E402
from repro_torch.core.mlalgos import LinReg  # noqa: E402
from repro_torch.data import (Prefetcher, RotationFeed,  # noqa: E402
                              StreamingDataset, TokenStream)
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.pipeline import (_release_window,  # noqa: E402
                                       make_scaled_local)
from test_torch_minibatch import jax_permutation  # noqa: E402
from torch_parity import assert_bits_equal, rng, to_numpy  # noqa: E402

JOIN_S = 10.0


def _xy(n=100, d=3, seed=1):
    r = rng(seed)
    return (r.normal(size=(n, d)).astype(np.float32),
            r.normal(size=n).astype(np.float32))


# -- quantize_fixed_scale -----------------------------------------------------


@pytest.mark.parametrize("bits", [8, 16])
def test_fixed_scale_quantization_equals_jax_with_ties(bits):
    """numpy and torch against JAX's ``quantize_fixed_scale``, with exact
    .5 ties on the grid (round half to even) and values past the range
    (the clip); and the global scale reproduces the resident
    ``quantize_symmetric(X, axis=0)`` row for row."""
    r = rng(7)
    x = (r.normal(size=(257, 9)) * 3).astype(np.float32)
    scale = np.array(jqz.symmetric_scale(
        np.abs(x).max(axis=0, keepdims=True), bits))
    x[:5] = scale[0] * np.array([0.5, 1.5, -0.5, -2.5, 7.5],
                                np.float32)[:, None]
    ref = np.asarray(jqz.quantize_fixed_scale(x, scale, bits).values)
    got_np = qz.quantize_fixed_scale_np(x, scale, bits)
    got = qz.quantize_fixed_scale(torch.from_numpy(x),
                                  torch.from_numpy(scale), bits)
    assert_bits_equal(got_np, ref)
    assert_bits_equal(got.values, ref)
    assert_bits_equal(got.scale, scale)
    assert_bits_equal(qz.quantize_fixed_scale_np(x, scale * 0.25, bits),
                      np.asarray(jqz.quantize_fixed_scale_np(
                          x, scale * 0.25, bits)))
    resident = qz.quantize_symmetric(torch.from_numpy(x), bits=bits, axis=0)
    port_scale = qz.symmetric_scale(
        torch.from_numpy(np.abs(x).max(axis=0, keepdims=True)), bits)
    assert_bits_equal(port_scale, resident.scale)
    assert_bits_equal(qz.quantize_fixed_scale_np(x[40:90], port_scale.numpy(),
                                                 bits),
                      resident.values[40:90])


def test_absmax_equals_jax():
    X, y = _xy(257, 5, 0)
    sd = StreamingDataset(X, y, partition_rows=64)
    jsd = JStreamingDataset(X, y, partition_rows=64)
    assert_bits_equal(sd.feature_absmax(block_rows=100),
                      jsd.feature_absmax(block_rows=100))
    assert_bits_equal(sd.label_absmax(block_rows=100),
                      jsd.label_absmax(block_rows=100))
    assert_bits_equal(sd.feature_absmax(),
                      np.abs(X).max(axis=0, keepdims=True))


# -- windows and the tag against JAX's ----------------------------------------


def _rotations(shuffle, precision, n=203, d=5, nv=4, part_rows=48, seed=3):
    X, y = _xy(n, d, 2)
    kw = dict(partition_rows=part_rows, seed=seed, shuffle=shuffle)
    sd = StreamingDataset(X, y, permutation=jax_permutation if shuffle
                          else None, **kw)
    jsd = JStreamingDataset(X, y, **kw)
    if precision is None:
        return sd.bind(make_cpu_grid(nv)), jsd.bind(jax_grid(nv))
    return (LinReg(precision=precision).bind_stream(make_cpu_grid(nv),
                                                    sd).data,
            JLinReg(precision=precision).bind_stream(jax_grid(nv),
                                                     jsd).data)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("precision", [None, "int8"])
def test_window_host_equals_jax(shuffle, precision):
    """Every window of two epochs (the padded last window and its zero
    mask included) bit-equal to JAX's: raw rows, and int8 rows and int16
    labels quantized on the worker against the global scales."""
    rot, jrot = _rotations(shuffle, precision)
    assert (rot.per, rot.part, rot.windows_per_epoch) == \
        (jrot.per, jrot.part, jrot.windows_per_epoch)
    for t in range(2 * rot.windows_per_epoch):
        got, want = rot.window_host(t), jrot.window_host(t)
        assert sorted(got) == sorted(want)
        for k in want:
            assert_bits_equal(got[k], want[k])


@pytest.mark.parametrize("shuffle", [False, True])
def test_tag_is_jax_text_in_order_and_names_the_permutation(shuffle):
    """``shuffle=False``: JAX's tag letter for letter (either package
    resumes the other's checkpoints).  ``shuffle=True``: the permutation
    is named, so a JAX streaming checkpoint is not resumed onto another
    row order."""
    rot, jrot = _rotations(shuffle, None)
    if not shuffle:
        assert rot.tag() == jrot.tag()
        return
    assert rot.tag() != jrot.tag()
    assert rot.tag().startswith(jrot.tag()[:-1])
    assert rot.tag().endswith(
        "perm=test_torch_minibatch.jax_permutation)")
    X, y = _xy()
    hashed = StreamingDataset(X, y, partition_rows=48).bind(make_cpu_grid(4))
    assert hashed.tag().endswith(", shuffle=True, perm=hashed)")


def test_token_stream_equals_jax():
    a = TokenStream(vocab_size=64, batch=4, seq_len=16, seed=11,
                    device="cpu")
    b = TokenStream(vocab_size=64, batch=4, seq_len=16, seed=11,
                    device="cpu")
    ja = JTokenStream(vocab_size=64, batch=4, seq_len=16, seed=11)
    it = iter(a)
    for step in (0, 1, 2, 7, 123):
        got = a.batch_at(step)["tokens"]
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert_bits_equal(got, ja.batch_at(step)["tokens"])
        assert torch.equal(got, b.batch_at(step)["tokens"])
    for step in range(3):
        assert torch.equal(next(it)["tokens"], a.batch_at(step)["tokens"])
    other = TokenStream(vocab_size=64, batch=4, seq_len=16, seed=12,
                        device="cpu")
    assert not torch.equal(other.batch_at(0)["tokens"],
                           a.batch_at(0)["tokens"])


def test_token_stream_defaults_to_the_card():
    # an entry point of the port: no device named means CUDA, and no card
    # means an error, never a quiet CPU tensor
    if torch.cuda.is_available():
        ts = TokenStream(vocab_size=64, batch=2, seq_len=8, seed=3)
        assert ts.batch_at(0)["tokens"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TokenStream(vocab_size=64, batch=2, seq_len=8, seed=3)


# -- the Prefetcher -----------------------------------------------------------


def test_prefetcher_preserves_order_and_transforms_on_the_worker():
    for depth in (1, 2, 5):
        pf = Prefetcher(iter(range(50)), depth=depth)
        assert list(pf) == list(range(50))
        pf.close()
    seen = []
    pf = Prefetcher(iter(range(8)), depth=2, transform=lambda x: (
        seen.append(threading.current_thread().name), x * 10)[1])
    assert list(pf) == [i * 10 for i in range(8)]
    pf.close()
    assert threading.current_thread().name not in seen


def test_prefetcher_exhaustion_is_sticky():
    pf = Prefetcher(iter(range(2)), depth=2)
    assert list(pf) == [0, 1]
    for _ in range(2):
        with pytest.raises(StopIteration):
            next(pf)
    pf.close()


def test_prefetcher_depth_validated():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(range(2)), depth=0)


def test_prefetcher_close_with_full_queue_does_not_deadlock():
    def infinite():
        i = 0
        while True:
            yield i
            i += 1

    pf = Prefetcher(infinite(), depth=1)
    assert next(pf) == 0
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 5.0
    assert not pf._thread.is_alive()


def test_prefetcher_next_after_close_raises_and_close_is_idempotent():
    pf = Prefetcher(iter(range(100)), depth=1)
    pf.close()
    pf.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(pf)


def test_prefetcher_close_wakes_a_blocked_consumer():
    release = threading.Event()

    def slow():
        yield 0
        release.wait(timeout=30)
        yield 1

    pf = Prefetcher(slow(), depth=1)
    assert next(pf) == 0
    got = []

    def consume():
        try:
            got.append(next(pf))
        except (StopIteration, RuntimeError) as e:
            got.append(type(e).__name__)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    time.sleep(0.05)
    release.set()
    pf.close()
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    assert len(got) == 1


def test_prefetcher_records_timings():
    pf = Prefetcher(iter(range(6)), depth=2)
    list(pf)
    assert len(pf.produce_s) == 6 and len(pf.stall_s) == 6
    assert all(s >= 0 for s in pf.produce_s + pf.stall_s)
    pf.close()


@pytest.mark.parametrize("where", ["iterator", "transform"])
def test_prefetcher_reraises_the_workers_exception(where):
    """A failed gather (the iterator) or copy (the transform) ends the
    stream with its own error, after the items before it, and again on
    every later ``next``: nothing ends silently."""
    def source():
        yield 0
        yield 1
        if where == "iterator":
            raise IndexError("gather failed")
        yield 2

    def transform(x):
        if where == "transform" and x == 2:
            raise IndexError("gather failed")
        return x

    pf = Prefetcher(source(), depth=2, transform=transform)
    assert [next(pf), next(pf)] == [0, 1]
    for _ in range(2):
        with pytest.raises(IndexError, match="gather failed"):
            next(pf)
    pf.close()
    assert not pf._thread.is_alive()


# -- StreamingDataset and PartitionRotation -----------------------------------


def test_streaming_dataset_validation():
    X, y = _xy(10, 2)
    with pytest.raises(ValueError, match="rows"):
        StreamingDataset(X, y[:9], partition_rows=4)
    for kw, what in ((dict(partition_rows=0), "partition_rows"),
                     (dict(partition_rows=4, prefetch_depth=-1),
                      "prefetch_depth"),
                     (dict(partition_rows=4, steps_per_window=0),
                      "steps_per_window")):
        with pytest.raises(ValueError, match=what):
            StreamingDataset(X, y, **kw)
    sd = StreamingDataset(X, y, partition_rows=4)
    assert (sd.n_rows, sd.n_features) == (10, 2)
    assert_bits_equal(sd.rows([3, 1]), X[[3, 1]])


def _rotation(n=100, d=3, part_rows=32, nv=4, **kw):
    X, y = _xy(n, d)
    return StreamingDataset(X, y, partition_rows=part_rows,
                            **kw).bind(make_cpu_grid(nv))


def test_window_shapes_and_placement():
    rot = _rotation()
    data = rot.window_data(0)
    nv, part = rot.grid.n_vdpus, rot.part
    assert set(data) == {"X", "w", "y0", "scale"}
    assert tuple(data["X"].shape) == (nv, part, 3)
    assert tuple(data["w"].shape) == (nv, part)
    assert tuple(data["scale"].shape) == (nv,)
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in data.values())
    host = rot.window_host(0)
    for k in host:
        assert_bits_equal(data[k], host[k])


def test_window_host_pure_in_t():
    rot = _rotation()
    a, b = rot.window_host(3), rot.window_host(3)
    for k in a:
        assert_bits_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle", [False, True])
def test_epoch_coverage_exact(shuffle):
    """An epoch of windows visits every real slot once and never a pad
    slot (the sampler's coverage, lifted to the host)."""
    rot = _rotation(n=100, nv=4, part_rows=32, shuffle=shuffle)
    per, nv = rot.per, rot.grid.n_vdpus
    slot_rows = np.arange(nv)[:, None] * per + np.arange(per)[None]
    visits = np.zeros((nv, per))
    for t in range(rot.windows_per_epoch):
        idx, _ = rot.schedule(t)
        np.add.at(visits, (slice(None), idx), rot.window_host(t)["w"])
    np.testing.assert_array_equal(visits, (slot_rows < 100).astype(float))


def test_exact_full_single_window():
    rot = _rotation(n=100, nv=4, part_rows=100)
    assert rot.exact_full and rot.windows_per_epoch == 1
    assert "scale" not in rot.window_host(0)


def test_prefetcher_matches_synchronous_windows():
    rot = _rotation()
    pf = rot.prefetcher(0, depth=2)
    try:
        for t in range(3):
            sync, pre = rot.window_data(t), next(pf)
            for k in sync:
                assert torch.equal(sync[k], pre[k])
    finally:
        pf.close()


def test_prefetcher_ends_at_stop():
    rot = _rotation()
    pf = rot.prefetcher(1, depth=2, stop=3)
    try:
        got = list(pf)
    finally:
        pf.close()
    assert len(got) == 2
    for t, win in zip((1, 2), got):
        for k, v in rot.window_host(t).items():
            assert_bits_equal(win[k], v)


def test_concurrent_gathers_stay_apart():
    """More gathering threads than cores, under a short switch interval:
    every window equals its serial gather (the gather buffers, the
    schedule cache and the staging are shared by the rotation)."""
    import sys

    rot = _rotation(n=400, part_rows=64, prefetch_depth=1)
    want = {t: rot.window_host(t) for t in range(8)}
    bad, done = [], []

    def gather(i):
        for t in ((i + j) % 8 for j in range(12)):
            got = rot.window_data(t)
            if any(not np.array_equal(got[k].numpy(), v)
                   for k, v in want[t].items()):
                bad.append(t)
        done.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=gather, args=(i,), daemon=True)
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == 16 and bad == []


def test_pad_rows_zeroed():
    rot = _rotation(n=10, nv=4, part_rows=12, shuffle=False)
    host = rot.window_host(rot.windows_per_epoch - 1)
    assert (host["w"] == 0).any()
    assert (host["X"][host["w"] == 0.0] == 0.0).all()


def test_schedule_cache_bounded():
    rot = _rotation()
    rot.prewarm_schedules(range(5000))
    assert len(rot._sched_cache) <= 4096


def test_int8_workload_stages_narrow_windows():
    """An int8 workload's window holds int8 rows and int16 labels, made
    in numpy on the worker, equal to the torch quantization of the same
    rows against the global scales."""
    X, y = _xy(96, 5, 3)
    sd = StreamingDataset(X, y, partition_rows=32, shuffle=False)
    prog = LinReg(lr=0.05, precision="int8").bind_stream(make_cpu_grid(4),
                                                         sd)
    host = prog.data.window_host(0)
    assert isinstance(host["X"], np.ndarray)
    assert host["X"].dtype == np.int8 and host["y0"].dtype == np.int16
    rot = prog.data
    idx, _ = rot.schedule(0)
    flat = (np.arange(4)[:, None] * rot.per + idx[None, :]).ravel()
    want = qz.quantize_fixed_scale(torch.from_numpy(X[flat]),
                                   prog.consts["x_scale"], 8).values
    assert_bits_equal(host["X"].reshape(-1, 5), want)


def test_scaled_local_broadcasts_the_lane_scale():
    """The window's ``(lanes,)`` scale multiplies each partial along its
    leading lane dim, and never reaches the wrapped ``local_fn``."""
    seen = {}

    def local_fn(state, sl):
        seen.update(sl)
        return {"g": sl["X"].sum(1), "loss": sl["w"].sum(1)}

    X = torch.arange(24.0).reshape(2, 3, 4)
    scale = torch.tensor([2.0, 0.5])
    out = make_scaled_local(local_fn)(None, {"X": X, "w": torch.ones(2, 3),
                                             "scale": scale})
    assert "scale" not in seen
    assert torch.equal(out["g"], X.sum(1) * scale[:, None])
    assert torch.equal(out["loss"], torch.full((2,), 3.0) * scale)
    d = {"X": X}
    _release_window(d)
    _release_window(None)
    assert d == {}


def test_rotation_feed_prefetches_in_order_and_rebuilds_on_rollback():
    rot = _rotation(prefetch_depth=2)
    calls = []
    host = rot.window_host

    def counted(t):
        calls.append(t)
        return host(t)

    rot.window_host = counted
    feed = RotationFeed(rot, 2)
    try:
        w0 = feed(0)
        assert feed(1) is w0                 # one window, two steps
        w1 = feed(2)
        assert w0 == {}                      # the window before is dropped
        for k, v in rot.place(host(1)).items():
            assert torch.equal(w1[k], v)
        again = feed(0)                      # a rollback: gathered again
        for k, v in rot.place(host(0)).items():
            assert torch.equal(again[k], v)
        assert calls.count(0) == 2
    finally:
        feed.close()
    assert feed._pf is None
    with pytest.raises(ValueError, match="steps_per_window"):
        RotationFeed(rot, 0)
    assert isinstance(to_numpy(feed(4)["X"]), np.ndarray)   # restarts
    feed.close()


def test_doc_examples():
    failed, tried = doctest.testmod(pipeline, verbose=False)
    assert tried > 0 and failed == 0
