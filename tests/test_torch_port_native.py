"""Port parity: the native graph utilities (``molkgnn_torch.native``).

The cases of ``tests/test_native.py``, each held bit for bit against the
JAX package's functions (its library built into a temporary directory, so
that nothing is written under ``molkgnn_tpu/``) and against the port's own
numpy versions; the two range gathers against a numpy expansion; where the
port's library lands; and that a failed build raises.
"""

from pathlib import Path

import numpy as np
import pytest

import molkgnn_tpu
from molkgnn_torch import native
from molkgnn_tpu import native as j_native


def _tpu_libraries():
    """Every graph_ops library under the JAX package."""
    return sorted(Path(molkgnn_tpu.__file__).parent.rglob("libgraph_ops*"))


def _chain_adj(n):
    adj = np.zeros((n, n), np.int64)
    for i in range(n - 1):
        adj[i, i + 1] = adj[i + 1, i] = 1
    return adj


def _random_adj(n=12, seed=0):
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.25).astype(np.int64)
    adj = np.maximum(adj, adj.T)
    np.fill_diagonal(adj, 0)
    return adj


def _two_pairs():
    adj = np.zeros((4, 4), np.int64)
    adj[0, 1] = adj[1, 0] = 1
    adj[2, 3] = adj[3, 2] = 1
    return adj


def _chain_feat(n=5, f=3):
    feat = np.zeros((n, n, f), np.float32)
    for i in range(n - 1):
        feat[i, i + 1] = [i + 1, 0, 0]
        feat[i + 1, i] = [-(i + 1), 0, 0]
    return feat


@pytest.fixture
def jax_native(tmp_path, monkeypatch):
    """The JAX package's native module with its library built under
    ``tmp_path`` (its own cache reset, restored afterwards)."""
    monkeypatch.setattr(j_native, "_LIB_PATH",
                        str(tmp_path / "libgraph_ops.so"))
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_tried", False)
    assert j_native.have_native()
    return j_native


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_native_library_builds():
    assert native.have_native(), "g++ build of graph_ops failed"


def test_library_lands_in_the_port_build_dir():
    before = _tpu_libraries()
    native.library()
    path = native.library_path()
    assert path.exists()
    assert path.parent == native.BUILD
    assert native.BUILD.parent.name == "molkgnn_torch"
    assert path.name.startswith("libgraph_ops_") and path.suffix == ".so"
    assert "molkgnn_tpu" not in str(path)
    assert _tpu_libraries() == before


@pytest.mark.parametrize("name,adj", [
    ("chain", _chain_adj(5)),
    ("disconnected", _two_pairs()),
    ("random", _random_adj()),
])
def test_floyd_warshall_matches_jax(jax_native, name, adj):
    got = native.floyd_warshall(adj)
    _equal(got, jax_native.floyd_warshall(adj))
    _equal(got, native.floyd_warshall_numpy(adj))
    dist = got[0]
    if name == "chain":
        for i in range(5):
            for j in range(5):
                assert dist[i, j] == abs(i - j)
    if name == "disconnected":
        assert dist[0, 1] == 1 and dist[0, 2] == native.UNREACHABLE
    if name == "random":
        from scipy.sparse.csgraph import shortest_path

        sp = shortest_path(adj.astype(float), unweighted=True)
        want = np.where(np.isinf(sp), native.UNREACHABLE, sp).astype(np.int64)
        np.testing.assert_array_equal(dist, want)


@pytest.mark.parametrize("name", ["chain", "random"])
def test_gen_edge_input_matches_jax(jax_native, name):
    if name == "chain":
        adj, feat = _chain_adj(5), _chain_feat()
    else:
        adj = _random_adj(10, seed=3)
        rng = np.random.default_rng(4)
        feat = (rng.standard_normal((10, 10, 4)) * adj[..., None]).astype(
            np.float32)
    dist, pred = native.floyd_warshall(adj)
    got = native.gen_edge_input(dist, pred, feat)
    jd, jp = jax_native.floyd_warshall(adj)
    _equal([got], [jax_native.gen_edge_input(jd, jp, feat)])
    _equal([got], [native.gen_edge_input_numpy(dist, pred, feat)])
    _equal([native.gen_edge_input(dist, pred, feat, max_dist=2)],
           [jax_native.gen_edge_input(jd, jp, feat, max_dist=2)])
    if name == "chain":
        # Path 0 -> 3 traverses edges (0,1), (1,2), (2,3); the reverse
        # direction uses the reverse edges' features.
        np.testing.assert_array_equal(got[0, 3, :3, 0], [1, 2, 3])
        assert got[3, 0, 0, 0] == -3


def _ranges_case():
    """Five ranges over 17 rows (one empty, two overlapping), their row
    numbers expanded and each row's range."""
    rng = np.random.default_rng(5)
    starts = np.array([0, 7, 3, 12, 12], np.int64)
    lens = np.array([3, 0, 4, 5, 1], np.int64)
    expand = np.concatenate([np.arange(s, s + n) for s, n in
                             zip(starts, lens)])
    owner = np.repeat(np.arange(len(lens)), lens)
    return rng, starts, lens, expand, owner


def test_ranges_gather_f32_matches_numpy():
    rng, starts, lens, expand, _ = _ranges_case()
    src = rng.standard_normal((17, 3)).astype(np.float32)
    out = np.empty((len(expand), 3), np.float32)
    native.library().ranges_gather_f32(src, 3, starts, lens, len(starts),
                                       out)
    np.testing.assert_array_equal(out, src[expand])


def test_ranges_gather_offset_i32_matches_numpy():
    rng, starts, lens, expand, owner = _ranges_case()
    src = rng.integers(-50, 50, (17, 2)).astype(np.int32)
    offsets = np.array([0, 100, -7, 1000, 3], np.int32)
    out = np.empty((len(expand), 2), np.int32)
    native.library().ranges_gather_offset_i32(src, 2, starts, lens, offsets,
                                              len(starts), out)
    np.testing.assert_array_equal(out, src[expand] + offsets[owner][:, None])


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: with no g++ the library functions raise, and
    have_native says False."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.have_native()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.floyd_warshall(_chain_adj(3))
