"""Port parity: host packing and the tensor ops of ``molkgnn_torch``.

The same numpy inputs go through the JAX package and the port. Host
packing must be bit-equal; the ops must match in fp64 (tolerance 1e-12:
the same arithmetic in another summation order) and in fp32 with bf16
product operands (tolerance 1e-5: both round the operands to bf16 and
accumulate in fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.data import synthetic as t_synth
from molkgnn_torch.graphs import batch as t_batch
from molkgnn_torch.graphs import molgraph as t_molgraph
from molkgnn_torch.models import common as t_common
from molkgnn_torch.ops import norm as t_norm
from molkgnn_torch.ops import permutations as t_perms
from molkgnn_torch.ops import segment as t_segment
from molkgnn_torch.ops import similarity as t_sim
from molkgnn_tpu.data import synthetic as j_synth
from molkgnn_tpu.graphs import batch as j_batch
from molkgnn_tpu.graphs import molgraph as j_molgraph
from molkgnn_tpu.models import common as j_common
from molkgnn_tpu.ops import norm as j_norm
from molkgnn_tpu.ops import permutations as j_perms
from molkgnn_tpu.ops import segment as j_segment
from molkgnn_tpu.ops import similarity as j_sim


def _x64(fn):
    """Run ``fn`` with jax_enable_x64 on, restoring it afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


def _assert_batch_equal(tb, jb):
    for f in dataclasses.fields(jb):
        jv, tv = getattr(jb, f.name), getattr(tb, f.name)
        if dataclasses.is_dataclass(jv):
            _assert_batch_equal(tv, jv)
            continue
        jv = np.asarray(jv)
        tv = tv.numpy()
        assert tv.dtype == jv.dtype, f.name
        np.testing.assert_array_equal(tv, jv, err_msg=f.name)


def test_host_packing_is_bit_equal():
    """Port random_dataset / receptive_fields / spec / batch_graphs give the
    JAX package's arrays bit for bit, including a padded partial batch."""
    tg = t_synth.random_dataset(seed=5, num_graphs=21, active_fraction=0.3)
    jg = j_synth.random_dataset(seed=5, num_graphs=21, active_fraction=0.3)
    for a, b in zip(tg, jg):
        for name in ("x", "p", "edge_index", "edge_attr", "atomic_num"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.y == b.y and a.idx == b.idx
        tf = t_molgraph.receptive_fields(a)
        jf = j_molgraph.receptive_fields(b)
        for d in range(1, 5):
            for name in ("focal_index", "nei_index", "nei_edge_attr"):
                np.testing.assert_array_equal(
                    getattr(tf[d], name), getattr(jf[d], name)
                )
    tspec = t_batch.spec_for_graphs(tg, batch_size=8)
    jspec = j_batch.spec_for_graphs(jg, batch_size=8)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    for start in (0, 8, 16):  # the last chunk holds 5 of 8 graphs
        _assert_batch_equal(
            t_batch.batch_graphs(tg[start : start + 8], tspec),
            j_batch.batch_graphs(jg[start : start + 8], jspec),
        )
    with pytest.raises(ValueError):
        t_batch.batch_graphs(tg[:9], tspec)


def test_permutation_tables_equal():
    for d in range(1, 5):
        np.testing.assert_array_equal(
            t_perms.perm_table(d), j_perms.perm_table(d)
        )
        assert t_perms.num_perms(d) == j_perms.num_perms(d)


def _rows_with_zeros(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(dtype)
    x[..., 1, :] = 0.0  # zero rows, as padded bucket rows are
    return x


@pytest.mark.parametrize(
    "dtype,matmul_dtype,tol",
    [("float64", None, 1e-12), ("float32", "bfloat16", 1e-5)],
)
def test_similarity_ops_match(dtype, matmul_dtype, tol):
    rng = np.random.default_rng(1)
    nei = _rows_with_zeros(rng, (9, 3, 11), dtype)
    sup = rng.standard_normal((4, 6, 3, 11)).astype(dtype)
    a = rng.standard_normal((9, 11)).astype(dtype)
    a[2] = 0.0
    b = rng.standard_normal((5, 11)).astype(dtype)
    t_mm = getattr(torch, matmul_dtype) if matmul_dtype else None
    j_mm = jnp.dtype(matmul_dtype) if matmul_dtype else None

    def run_jax():
        return (
            np.asarray(j_sim.normalize_rows(jnp.asarray(nei))),
            np.asarray(j_sim.cosine_matrix(jnp.asarray(a), jnp.asarray(b))),
            np.asarray(
                j_sim.neighborhood_similarity(
                    jnp.asarray(nei), jnp.asarray(sup), matmul_dtype=j_mm
                )
            ),
        )

    want = _x64(run_jax) if dtype == "float64" else run_jax()
    got = (
        t_sim.normalize_rows(torch.from_numpy(nei)).numpy(),
        t_sim.cosine_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        t_sim.neighborhood_similarity(
            torch.from_numpy(nei), torch.from_numpy(sup), t_mm
        ).numpy(),
    )
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_segment_ops_match_fp64():
    rng = np.random.default_rng(2)
    n, e, f, b = 13, 20, 5, 3
    values = rng.standard_normal((n, f))
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    edge_mask = np.arange(e) < 15  # padded edges
    gid = np.sort(rng.integers(0, b, n)).astype(np.int32)
    node_mask = np.arange(n) < 11

    def run_jax():
        v = jnp.asarray(values)
        return (
            np.asarray(
                j_segment.gather_scatter_add(
                    v, jnp.asarray(src), jnp.asarray(dst), n,
                    edge_mask=jnp.asarray(edge_mask),
                )
            ),
            np.asarray(
                j_segment.global_add_pool(
                    v, jnp.asarray(gid), b, node_mask=jnp.asarray(node_mask)
                )
            ),
            np.asarray(j_segment.segment_sum_nodes(v, jnp.asarray(gid), b)),
        )

    want = _x64(run_jax)
    v = torch.from_numpy(values)
    got = (
        t_segment.gather_scatter_add(
            v, torch.from_numpy(src), torch.from_numpy(dst), n,
            edge_mask=torch.from_numpy(edge_mask),
        ).numpy(),
        t_segment.global_add_pool(
            v, torch.from_numpy(gid), b,
            node_mask=torch.from_numpy(node_mask),
        ).numpy(),
        t_segment.segment_sum_nodes(v, torch.from_numpy(gid), b).numpy(),
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_masked_batchnorm_matches_fp64(masked):
    """Train-mode output and running-stat update, then eval with the
    updated stats, against the JAX MaskedBatchNorm."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 4)) * 3.0 + 1.0
    mask = (np.arange(10) < 7) if masked else None
    weight = rng.standard_normal(4)
    bias = rng.standard_normal(4)

    def run_jax():
        bn = j_norm.MaskedBatchNorm(4)
        v = {
            "params": {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)},
            "batch_stats": {
                "mean": jnp.zeros(4, jnp.float64),
                "var": jnp.ones(4, jnp.float64),
            },
        }
        jm = None if mask is None else jnp.asarray(mask)
        y, upd = bn.apply(v, jnp.asarray(x), mask=jm, mutable=["batch_stats"])
        v = {"params": v["params"], **upd}
        y_eval = bn.apply(v, jnp.asarray(x), mask=jm, use_running_average=True)
        st = upd["batch_stats"]
        return [np.asarray(t) for t in (y, st["mean"], st["var"], y_eval)]

    want = _x64(run_jax)
    bn = t_norm.MaskedBatchNorm(4).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    tm = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        y = bn.train()(torch.from_numpy(x), mask=tm)
        stats = (bn.running_mean.clone(), bn.running_var.clone())
        y_eval = bn.eval()(torch.from_numpy(x), mask=tm)
    got = [t.numpy() for t in (y, *stats, y_eval)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def test_linear_and_swish_match():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    lin = t_common.TorchLinear(9, 5, generator=torch.Generator().manual_seed(0))
    bound = 1.0 / np.sqrt(9)
    assert lin.weight.abs().max() <= bound and lin.bias.abs().max() <= bound
    kernel = lin.weight.detach().numpy().T  # JAX kernels are [in, out]
    bias = lin.bias.detach().numpy()
    want = j_common.TorchLinear(5).apply(
        {"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)
    )
    got = lin(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_common.swish(torch.from_numpy(x)).numpy(),
        np.asarray(j_common.swish(jnp.asarray(x))),
        rtol=1e-6,
        atol=1e-6,
    )
