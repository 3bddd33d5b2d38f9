"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a fixed seed and handed to both
packages; JAX stays on the CPU and values cross as numpy arrays.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def to_torch(x) -> "torch.Tensor":
    """A numpy (or JAX) array as a CPU tensor, dtype kept."""
    return torch.from_numpy(np.array(np.asarray(x)))


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_bits_equal(port, ref) -> None:
    """Same dtype, shape and bytes (so -0.0 != 0.0 and NaN payloads
    count)."""
    a, b = to_numpy(port), to_numpy(ref)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, a.shape,
                                                        b.dtype, b.shape)
    bits = np.dtype(f"u{a.dtype.itemsize}")
    np.testing.assert_array_equal(np.ascontiguousarray(a).view(bits),
                                  np.ascontiguousarray(b).view(bits))


def require_cuda() -> "torch.device":
    """Skip the calling test when there is no CUDA device (decided when the
    test runs, never when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def classification(seed: int, n: int, d: int):
    r = rng(seed)
    X = r.standard_normal((n, d)).astype(np.float32)
    w = (r.standard_normal(d) * 2.0 / np.sqrt(d)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ w)))
    y = (r.random(n) < p).astype(np.float32)
    return X, y


def regression(seed: int, n: int, d: int):
    r = rng(seed)
    X = r.standard_normal((n, d)).astype(np.float32)
    w = r.standard_normal(d).astype(np.float32)
    y = (X @ w + 0.1 * r.standard_normal(n)).astype(np.float32)
    return X, y


def blobs(seed: int, n: int, d: int, k: int, spread: float = 0.3):
    """``k`` gaussian blobs with centres uniform in [-2, 2]^d."""
    r = rng(seed)
    centers = r.uniform(-2.0, 2.0, (k, d)).astype(np.float32)
    X = centers[r.integers(0, k, n)] + spread * r.standard_normal((n, d))
    return X.astype(np.float32)


def mixture(seed: int, n: int, d: int, n_classes: int,
            clusters_per_class: int = 2, spread: float = 0.5):
    """A labelled gaussian mixture (component ``c`` has label
    ``c % n_classes``), as ``repro.core.datasets.mixture_classification``
    draws it."""
    r = rng(seed)
    k = n_classes * clusters_per_class
    centers = r.uniform(-2.0, 2.0, (k, d)).astype(np.float32)
    comp = r.integers(0, k, n)
    X = centers[comp] + spread * r.standard_normal((n, d))
    return X.astype(np.float32), (comp % n_classes).astype(np.int32)


def top_two_gap(xf, c):
    """Per row, the gap between its two nearest centroids' squared
    distances, in float64: a row whose gap is within rounding may go to
    either centroid in another summation order."""
    d = ((xf[..., None, :].astype(np.float64) - c[..., None, :, :]) ** 2
         ).sum(-1)
    d.sort(axis=-1)
    return d[..., 1] - d[..., 0]


@contextlib.contextmanager
def single_process_world(backend: str = "gloo"):
    """A world of this one process for the duration (the one that exists
    is kept, and one started here is ended after)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    started = not dist.is_initialized()
    init_world(backend)
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def jax_place(cfg, path: tuple):
    """The key path of the JAX leaf that holds the port's leaf at ``path``
    (``tree.tree_flatten_with_keys``' spelling) in a parameter, optimizer
    or cache tree of JAX config ``cfg``, and whether that leaf is stacked
    (a leading repeat axis): JAX ``lax.scan``s the repeating unit of the
    layer pattern (``stack``/``scan``, one leaf a unit position, the rest
    in ``tail``) and an encoder-decoder's layers; the port keeps one dict
    a layer."""
    path = list(path)
    for i, k in enumerate(path):
        nxt = path[i + 1] if i + 1 < len(path) else None
        if k == "layers" and isinstance(nxt, int):
            pre, j, rest = path[:i], nxt, path[i + 2:]
            if pre and pre[-1] in ("encoder", "decoder"):
                return tuple(pre + ["scan"] + rest), True
            unit, reps, tail = cfg.scan_groups()
            if j < reps * len(unit):
                return tuple(pre + ["stack", "scan", j % len(unit)]
                             + rest), True
            return tuple(pre + ["stack", "tail", j - reps * len(unit)]
                         + rest), False
    if cfg.encoder is not None and path[0] in ("self", "cross"):
        return tuple([path[0]] + path[2:]), True          # an encdec cache
    if isinstance(path[0], int):                          # an LM cache
        unit, reps, tail = cfg.scan_groups()
        j = path[0]
        if j < reps * len(unit):
            return tuple(["scan", j % len(unit)] + path[1:]), True
        return tuple(["tail", j - reps * len(unit)] + path[1:]), False
    return tuple(path), False
