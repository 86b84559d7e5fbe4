"""Port parity: KernelConv, MolKGNNNet / GNNModel and the weight bridge.

Both packages run on the same numpy inputs with the same weights, carried
over by ``molkgnn_torch.training.checkpoint.from_jax_variables``.

  * fp64 (JAX with jax_enable_x64, the port in double): tolerance 1e-9,
    the same arithmetic in another summation order. Deep models use
    tie-free molecules, so no permutation argmax rests on an exact tie.
  * fp32 against the JAX Pallas path (interpret mode) at one layer, where
    layer-1 inputs are random and ties have measure zero: tolerance 1e-5,
    as ``tests/test_pallas.py`` uses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.data.synthetic import random_dataset, tie_free_molgraph
from molkgnn_torch.graphs import batch as t_batch
from molkgnn_torch.models import kgnn as t_kgnn
from molkgnn_torch.training.checkpoint import from_jax_variables
from molkgnn_torch.training.model import GNNModel
from molkgnn_tpu.graphs import batch as j_batch
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models import kgnn as j_kgnn
from molkgnn_tpu.training.checkpoint import from_torch_state_dict
from molkgnn_tpu.training.model import GNNModel as JGNNModel

SMALL = dict(kernels_1hop=(2, 3, 4, 5), kernels_nhop=(2, 3, 4, 5))


def _as64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating)
        else np.asarray(a),
        tree,
    )


def _x64(fn):
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_graph(g):
    return JMolGraph(
        x=g.x, p=g.p, edge_index=g.edge_index, edge_attr=g.edge_attr,
        y=g.y, atomic_num=g.atomic_num,
    ).with_fields()


def _conv_inputs(rng, m, deg, f=28, e=7):
    x_nei = rng.standard_normal((m, deg, f))
    if deg == 4:
        # An achiral neighborhood. The two equal neighbors also tie the
        # scores of two permutations exactly at degrees 2 and 3, so only
        # degree 4 (whose even permutations do not swap one pair) has one.
        x_nei[3, 1] = x_nei[3, 0]
    return (
        rng.standard_normal((m, f)),
        rng.standard_normal((m, 3)),
        x_nei,
        rng.standard_normal((m, deg, 3)),
        rng.standard_normal((m, deg, e)),
        np.arange(m) < m - 2,  # two padded rows
    )


def _as_double(batch):
    """The batch with its floating-point fields in float64."""
    cast = lambda t: t.double() if t.is_floating_point() else t
    return dataclasses.replace(
        batch,
        x=cast(batch.x), p=cast(batch.p), edge_attr=cast(batch.edge_attr),
        y=cast(batch.y),
        **{
            f"deg{d}": dataclasses.replace(
                b, nei_edge_attr=cast(b.nei_edge_attr)
            )
            for d, b in enumerate(batch.buckets(), start=1)
        },
    )


def _port_conv(params, deg, dtype, use_kernel):
    conv = t_kgnn.KernelConv(
        deg=deg, num_kernels=5, node_dim=28, edge_dim=7, use_kernel=use_kernel
    ).to(dtype)
    conv.load_state_dict(
        {k: torch.tensor(np.asarray(v)) for k, v in params.items()},
        strict=True,
    )
    return conv


@pytest.mark.parametrize(
    "deg,last", [(1, False), (2, False), (3, False), (4, False), (4, True)]
)
def test_kernelconv_matches_jax_fp64(deg, last):
    """Every degree, incl. the deg-4 last-layer chirality sign, against the
    JAX XLA form in fp64; the port's XLA form and its scorer path (plain
    version on the CPU) both."""
    rng = np.random.default_rng(deg)
    args = _conv_inputs(rng, 10, deg)
    jconv = j_kgnn.KernelConv(deg=deg, num_kernels=5, node_dim=28, edge_dim=7)
    args32 = [np.asarray(a, np.float32) if a.dtype == np.float64 else a
              for a in args]
    init = jax.jit(jconv.init, static_argnums=7)
    params = _as64(init(jax.random.key(deg), *args32, last))["params"]
    want = _x64(
        lambda: np.asarray(
            jax.jit(jconv.apply, static_argnums=7)(
                {"params": params}, *map(jnp.asarray, args), last
            )
        )
    )
    targs = [torch.from_numpy(a) for a in args]
    for use_kernel in (False, True):
        conv = _port_conv(params, deg, torch.float64, use_kernel)
        got = conv(*targs, is_last_layer=last).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert np.all(got[-2:] == 0.0)  # padded rows


def test_kernelconv_kernel_path_matches_jax_pallas_fp32():
    """KernelConv(use_kernel=True) against JAX KernelConv(use_pallas=True),
    the pattern of tests/test_pallas.py::test_kernelconv_pallas_path."""
    rng = np.random.default_rng(3)
    args = [np.asarray(a, np.float32) if a.dtype == np.float64 else a
            for a in _conv_inputs(rng, 12, 4)]
    jconv = j_kgnn.KernelConv(
        deg=4, num_kernels=5, node_dim=28, edge_dim=7, use_pallas=True
    )
    v = jax.jit(jconv.init, static_argnums=7)(jax.random.key(0), *args, True)
    apply = jax.jit(jconv.apply, static_argnums=7)
    want = np.asarray(apply(v, *map(jnp.asarray, args), True))
    conv = _port_conv(jax.device_get(v["params"]), 4, torch.float32, True)
    got = conv(*map(torch.from_numpy, args), is_last_layer=True)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)


def _models(num_layers, use_pallas=False, use_kernel=False, **kw):
    cfg = dict(num_layers=num_layers, graph_embedding_dim=8, **SMALL, **kw)
    jm = JGNNModel(
        encoder=j_kgnn.MolKGNNNet(**cfg, use_pallas=use_pallas),
        ffn_dropout_rate=0.0,
    )
    tm = GNNModel(
        t_kgnn.MolKGNNNet(**cfg, use_kernel=use_kernel), ffn_dropout_rate=0.0
    )
    return jm, tm.eval()


def test_molkgnn_one_layer_matches_jax_pallas_fp32():
    graphs = random_dataset(seed=11, num_graphs=8)
    jgraphs = [_jax_graph(g) for g in graphs]
    spec = t_batch.spec_for_graphs(graphs, batch_size=8)
    jbatch = j_batch.batch_graphs(jgraphs, j_batch.spec_for_graphs(jgraphs, 8))
    jm, tm = _models(1, use_pallas=True, use_kernel=True)
    v = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jbatch))
    tm.load_state_dict(from_jax_variables(v), strict=True)
    want_pred, want_emb = jax.jit(jm.apply)(v, jbatch)
    with torch.no_grad():
        pred, emb = tm(t_batch.batch_graphs(graphs, spec))
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(want_emb), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        pred.numpy(), np.asarray(want_pred), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize(
    "use_kernel,every_layer", [(False, False), (True, False), (True, True)]
)
def test_molkgnn_three_layers_match_jax_fp64_tie_free(use_kernel, every_layer):
    """3 layers in fp64 on tie-free molecules; also with the deg-4
    chirality sign at every layer (chirality_every_layer)."""
    rng = np.random.default_rng(21)
    graphs = [tie_free_molgraph(rng) for _ in range(6)]
    jgraphs = [_jax_graph(g) for g in graphs]
    spec = t_batch.spec_for_graphs(graphs, batch_size=6)
    jbatch = j_batch.batch_graphs(jgraphs, j_batch.spec_for_graphs(jgraphs, 6))
    jm, tm = _models(
        3, use_kernel=use_kernel, chirality_every_layer=every_layer
    )
    v = _as64(jax.device_get(jax.jit(jm.init)(jax.random.key(1), jbatch)))
    want_pred, want_emb = _x64(
        lambda: jax.device_get(jax.jit(jm.apply)(v, _as64(jbatch)))
    )
    tm = tm.double()
    tm.load_state_dict(from_jax_variables(v), strict=True)
    batch = _as_double(t_batch.batch_graphs(graphs, spec))
    with torch.no_grad():
        pred, emb = tm(batch)
    np.testing.assert_allclose(emb.numpy(), want_emb, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(pred.numpy(), want_pred, rtol=1e-9, atol=1e-9)


def test_weight_bridge_round_trips():
    """JAX -> port loads with strict=True; the port's state_dict goes back
    through the JAX importer into a GNNModel.init template with no missing
    or extra keys and identical arrays."""
    graphs = random_dataset(seed=2, num_graphs=4)
    jgraphs = [_jax_graph(g) for g in graphs]
    jbatch = j_batch.batch_graphs(jgraphs, j_batch.spec_for_graphs(jgraphs, 4))
    jm, _ = _models(2)
    template = jax.device_get(jax.jit(jm.init)(jax.random.key(0), jbatch))

    sd_from_jax = from_jax_variables(template)
    _, tm = _models(2)
    tm.load_state_dict(sd_from_jax, strict=True)
    assert set(sd_from_jax) == set(tm.state_dict())
    assert "gnn_model.gnn.layers.1.trainable_kernelconv_set.3.p_support" in (
        sd_from_jax
    )

    gen = torch.Generator().manual_seed(5)
    port = GNNModel(
        t_kgnn.MolKGNNNet(
            num_layers=2, graph_embedding_dim=8, **SMALL, generator=gen
        ),
        generator=gen,
    )
    sd = port.state_dict()
    imported = from_torch_state_dict(template, sd)  # raises on any mismatch
    back = from_jax_variables(imported)
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy(), err_msg=k)
