"""Port parity: the model-parallel host partitioners and model options,
in one process, against the JAX package.

  * ``partition_halo``, ``partition_hybrid``, ``partition_batch`` (the
    edge-partition baseline) and ``halo_stats`` on the same batches give the
    JAX package's arrays bit for bit, at 2 and 4 shards and with pinned
    capacities; an overflowing pinned capacity raises the same
    ``ValueError``; the Trainer's pinned capacities grow as the JAX
    Trainer's do.
  * ``matmul_dtype=torch.bfloat16`` (fp32) against the JAX model's
    ``matmul_dtype="bfloat16"`` on the same weights: within 1e-6, the
    same rounded operands summed in another order. Rounding to bf16 turns
    a last-bit change of the normalised operands into a bf16 step: on the
    plain route (the support score in bf16 too) the flagship's embeddings
    then move by more than 1e-5, against under 1e-6 with fp32 products
    (why the card's plain bf16 route is held to the CPU at 1e-4).
  * ``psum_group`` over a world of one equals no group, bit for bit.
  * The CLI's hybrid divisibility message is the JAX CLI's.
  * What the JAX halo forward does with fixed kernel sets and with
    ``chirality_every_layer`` (pinned here), and the port's refusals.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from molkgnn_torch.cli import entry as t_entry
from molkgnn_torch.data.synthetic import random_dataset, tie_free_molgraph
from molkgnn_torch.graphs import batch as t_batch
from molkgnn_torch.models.kgnn import MolKGNNNet as TNet
from molkgnn_torch.parallel import halo as t_halo
from molkgnn_torch.parallel import hybrid as t_hybrid
from molkgnn_torch.parallel.data_parallel import make_mesh
from molkgnn_torch.training.model import GNNModel as TModel
from molkgnn_tpu.cli import entry as j_entry
from molkgnn_tpu.graphs import batch as j_batch
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models import kgnn as j_kgnn
from molkgnn_tpu.parallel import halo as j_halo
from molkgnn_tpu.parallel import hybrid as j_hybrid
from molkgnn_tpu.training.checkpoint import from_torch_state_dict
from molkgnn_tpu.training.model import GNNModel as JModel

SMALL = dict(kernels_1hop=(2, 3, 2, 3), kernels_nhop=(2, 3, 2, 3),
             graph_embedding_dim=8)
B = 16


def _jax_graph(g):
    return JMolGraph(x=g.x, p=g.p, edge_index=g.edge_index,
                     edge_attr=g.edge_attr, y=g.y,
                     atomic_num=g.atomic_num).with_fields()


def _batches(graphs, n_batches=2, batch=B):
    """The port's and the JAX package's batches of the same graphs."""
    t_spec = t_batch.spec_for_graphs(graphs, batch)
    jgraphs = [_jax_graph(g) for g in graphs]
    j_spec = j_batch.spec_for_graphs(jgraphs, batch)
    return ([t_batch.batch_graphs(graphs[i * batch:(i + 1) * batch], t_spec)
             for i in range(n_batches)],
            [j_batch.batch_graphs(jgraphs[i * batch:(i + 1) * batch], j_spec)
             for i in range(n_batches)])


@pytest.fixture(scope="module")
def synthetic():
    """Batches of the synthetic molecules (degrees 1-4, rings)."""
    return _batches(random_dataset(seed=3, num_graphs=2 * B))


def _leaves(tree):
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _leaves(getattr(tree, f.name))]
    return [np.asarray(tree)]


def _assert_bit_equal(got, want):
    g, w = _leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
def test_partition_halo_bit_equal(synthetic, shards, pinned):
    """partition_halo and halo_stats equal the JAX package's on each
    batch; pinned: the second batch under capacities widened from the
    first's, as a run pins them."""
    tb, jb = synthetic
    caps = None
    if pinned:
        base = j_halo.partition_halo(jb[0], shards).caps()
        caps = {k: (tuple(b + 16 for b in v) if k == "buckets"
                    else v if k == "ns" else v + 16)
                for k, v in base.items()}
    for t, j in zip(tb, jb):
        got = t_halo.partition_halo(t, shards, caps=caps)
        want = j_halo.partition_halo(j, shards, caps=caps)
        _assert_bit_equal(got, want)
        assert got.caps() == want.caps()
        assert t_halo.halo_stats(got) == j_halo.halo_stats(want)
    assert t_halo.halo_stats(got)["halo_edges"] > 0  # a real cut


@pytest.mark.parametrize("shards", [2, 4])
def test_partition_hybrid_and_batch_bit_equal(synthetic, shards):
    """partition_hybrid (2 data groups) and the edge partition's
    partition_batch equal the JAX package's."""
    tb, jb = synthetic
    _assert_bit_equal(t_hybrid.partition_hybrid(tb, shards),
                      j_hybrid.partition_hybrid(jb, shards))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from molkgnn_torch.parallel import edge_partition as t_edge
        from molkgnn_tpu.parallel import edge_partition as j_edge
    _assert_bit_equal(t_edge.partition_batch(tb[0], shards),
                      j_edge.partition_batch(jb[0], shards))


def test_pinned_caps_overflow_raises_as_jax(synthetic):
    """A pinned capacity the batch overflows raises the JAX package's
    ValueError."""
    tb, jb = synthetic
    caps = {**j_halo.partition_halo(jb[0], 4).caps(), "el": 8}
    with pytest.raises(ValueError) as want:
        j_halo.partition_halo(jb[0], 4, caps=caps)
    with pytest.raises(ValueError) as got:
        t_halo.partition_halo(tb[0], 4, caps=caps)
    assert str(got.value) == str(want.value)
    assert "pinned cap el=8 overflowed" in str(got.value)


def test_trainer_caps_grow_as_jax(synthetic):
    """The Trainer's pinned capacities (the first batch's widened by half,
    rounded to 8; grown from an overflowing batch) equal the JAX Trainer's
    over the same batches, tiny capacities first."""
    from molkgnn_torch.training.trainer import Trainer as TTrainer
    from molkgnn_tpu.training.trainer import Trainer as JTrainer

    tb, jb = synthetic
    tiny = {**j_halo.partition_halo(jb[0], 4).caps(), "hp": 8, "el": 8,
            "eh": 8, "buckets": (8,) * 4}
    port = types.SimpleNamespace(_mp=types.SimpleNamespace(n_model=4),
                                 _caps=dict(tiny))
    jax_self = types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape={"data": 4}), _halo_caps=None)
    for step, (t, j) in enumerate(zip(tb, jb)):
        if step == 1:
            port._caps = jax_self._halo_caps = dict(tiny)
        got = TTrainer._partition(port, [t])
        want = JTrainer._partition_halo_pinned(jax_self, j)
        assert port._caps == jax_self._halo_caps
        _assert_bit_equal(got, jax.tree.map(lambda a: a[None], want))


def _tie_free(n):
    rng = np.random.default_rng(9)
    return [tie_free_molgraph(rng) for _ in range(n)]


def _variables(jmodel, batch, seed=0, **kw):
    """The JAX template of ``jmodel`` (traced, not compiled) filled with
    the port's seeded weights of the same configuration, and that port
    model."""
    gen = torch.Generator().manual_seed(seed)
    port = TModel(TNet(generator=gen, **kw), ffn_dropout_rate=0.0,
                  generator=gen)
    template = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jmodel.init, jax.random.key(0), batch))
    return from_torch_state_dict(template, port.state_dict()), port


def test_bf16_products_match_jax():
    """MolKGNNNet(matmul_dtype=torch.bfloat16) against the JAX model with
    matmul_dtype="bfloat16" (fp32, the same weights, 2 layers, tie-free
    molecules): the pooled embeddings within 1e-6; both differ from the
    fp32 products."""
    (tb,), (jb,) = _batches(_tie_free(8), n_batches=1, batch=8)
    jmodel = JModel(encoder=j_kgnn.MolKGNNNet(
        num_layers=2, matmul_dtype="bfloat16", **SMALL))
    variables, model = _variables(jmodel, jb, num_layers=2,
                                  matmul_dtype=torch.bfloat16, **SMALL)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jb)[1])
    port = model.gnn_model
    port.eval()
    with torch.no_grad():
        got = port(tb).numpy()
        port.gnn.layers.apply(lambda m: setattr(m, "matmul_dtype", None))
        full = port(tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(full - got).max() > 1e-4


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_bf16_products_amplify_last_bit_changes(monkeypatch, route):
    """The flagship (4 layers) on 64 tie-free molecules, its operands
    normalised as usual and then in float64 (each element within four
    float32 ulps of the usual, as the card's may differ): the embeddings
    move by
    under 1e-6 with fp32 products; with bf16 products by more than 1e-5
    on the plain route and by under 1e-5 on the kernel route, whose
    support score stays fp32 (only the edge score, on the raw edge
    features, is rounded)."""
    from molkgnn_torch.models import kgnn as t_kgnn
    from molkgnn_torch.ops import similarity

    rng = np.random.default_rng(14)
    graphs = [tie_free_molgraph(rng) for _ in range(64)]
    batch = t_batch.batch_graphs(graphs, t_batch.spec_for_graphs(graphs, 64))
    usual = similarity.normalize_rows

    def wide(t):
        return usual(t.double()).to(t.dtype)

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1000, 28)).astype(np.float32))
    ulp = torch.from_numpy(np.spacing(np.maximum(
        usual(x).abs().numpy(), wide(x).abs().numpy())))
    assert torch.all((wide(x) - usual(x)).abs() <= 4 * ulp)
    assert not torch.equal(wide(x), usual(x))
    moved = {}
    for dtype in (None, torch.bfloat16):
        model = TNet(use_kernel=route == "kernel", matmul_dtype=dtype,
                     generator=torch.Generator().manual_seed(15)).eval()
        outs = []
        for fn in (usual, wide):
            monkeypatch.setattr(similarity, "normalize_rows", fn)
            monkeypatch.setattr(t_kgnn, "normalize_rows", fn)
            with torch.no_grad():
                outs.append(model(batch))
        moved[dtype] = float((outs[0] - outs[1]).abs().max())
    assert moved[None] < 1e-6
    if route == "plain":
        assert moved[torch.bfloat16] > 1e-5
    else:
        assert moved[None] < moved[torch.bfloat16] < 1e-5


def test_psum_group_of_one_equals_none():
    """A model whose psum_group is a world of one gives the forward and the
    gradients of the same model without one, bit for bit."""
    graphs = _tie_free(8)
    batch = t_batch.batch_graphs(graphs, t_batch.spec_for_graphs(graphs, 8))
    try:
        mesh = make_mesh(1, device="cpu")
        runs = []
        for group in (None, mesh.get_group("data")):
            gen = torch.Generator().manual_seed(1)
            model = TModel(TNet(num_layers=2, generator=gen,
                                psum_group=group, **SMALL),
                           ffn_dropout_rate=0.0, generator=gen)
            pred, emb = model(batch)
            pred.sum().backward()
            runs.append([emb] + [p.grad for p in model.parameters()
                                 if p.grad is not None])
    finally:
        dist.destroy_process_group()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cli_hybrid_divisibility_message_is_jax(tmp_path):
    """--model_parallel hybrid with ranks not divisible by
    --num_data_shards exits with the JAX CLI's message, before any rank
    starts."""
    argv = ["--model_parallel", "hybrid", "--num_devices", "3",
            "--dataset_name", "synthetic", "--synthetic_graphs", "16",
            "--default_root_dir", str(tmp_path)]
    with pytest.raises(SystemExit) as want:
        j_entry.main(argv)
    with pytest.raises(SystemExit) as got:
        t_entry.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert str(got.value) == ("--num_devices 3 not divisible by"
                              " --num_data_shards 2")


def _fixed_sets():
    rng = np.random.default_rng(4)
    return tuple(
        {"x_center": rng.standard_normal((2, 28)),
         "x_support": rng.standard_normal((2, d, 28)),
         "edge_attr_support": rng.standard_normal((2, d, 7)),
         "p_support": rng.standard_normal((2, d, 3))}
        for d in range(1, 5))


def test_jax_halo_drops_chirality_every_layer_port_refuses():
    """Pinned: the JAX halo forward applies the chirality sign at the
    last layer only, so a model with chirality_every_layer gives what the
    same weights give without it, not what the model gives on one device
    (the option is dropped). The port refuses such a model (not kept)."""
    (tb,), (jb,) = _batches(_tie_free(8), n_batches=1, batch=8)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    outs = {}
    for every in (False, True):
        model = j_kgnn.MolKGNNNet(num_layers=2, chirality_every_layer=every,
                                  **SMALL)
        if not every:  # the same weights for both
            v, _ = _variables(JModel(encoder=model), jb, num_layers=2,
                              **SMALL)
            variables = {k: v[k]["encoder"] for k in v}
        outs[every] = np.asarray(jax.jit(model.apply)(variables, jb))
    halo = np.asarray(j_halo.halo_parallel_forward(model, mesh)(
        variables, j_halo.partition_halo(jb, 2)))
    assert np.abs(outs[True] - outs[False]).max() > 1e-3
    np.testing.assert_allclose(halo, outs[False], rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="chirality_every_layer"):
        t_halo.check_model(TNet(num_layers=2, chirality_every_layer=True,
                                **SMALL))


def test_jax_halo_fails_on_fixed_sets_port_refuses():
    """Pinned: the JAX halo forward builds its layers without the fixed
    kernel sets, and the model's own embedding layer then meets features
    narrower than its weights: it raises. The port refuses such a model
    with its reason (not kept)."""
    (tb,), (jb,) = _batches(_tie_free(8), n_batches=1, batch=8)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    model = j_kgnn.MolKGNNNet(num_layers=1, fixed_kernels=_fixed_sets(),
                              **SMALL)
    variables = jax.tree.map(  # the failure is one of shapes
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(model.init, jax.random.key(0), jb))
    with pytest.raises(Exception) as err:
        j_halo.halo_parallel_forward(model, mesh)(
            variables, j_halo.partition_halo(jb, 2))
    assert type(err.value).__name__ == "ScopeParamShapeError"
    with pytest.raises(ValueError, match="fixed kernel sets"):
        t_halo.check_model(TNet(num_layers=1, fixed_kernels=_fixed_sets(),
                                **SMALL))


@pytest.mark.parametrize("case", ["no mesh", "unknown", "balanced",
                                  "hybrid on 1D", "point family"])
def test_trainer_model_parallel_refusals(case):
    """TrainConfig.model_parallel's checks, with the JAX Trainer's
    messages where it has one."""
    from molkgnn_torch.data.dataset import make_synthetic_dataset
    from molkgnn_torch.training.trainer import TrainConfig, Trainer

    ds = make_synthetic_dataset(seed=0, num_graphs=24)
    spec = t_batch.spec_for_graphs(ds.graphs, 8)
    kw = dict(batch_size=8, model_parallel="halo", progress=False)
    message = {"no mesh": "requires a mesh", "unknown": "unknown",
               "balanced": "balanced_batches",
               "hybrid on 1D": "needs a 2D mesh",
               "point family": "kgnn batch family only"}[case]
    if case == "unknown":
        kw["model_parallel"] = "pipeline"
    elif case == "balanced":
        kw["balanced_batches"] = True
    elif case == "hybrid on 1D":
        kw["model_parallel"] = "hybrid"
    elif case == "point family":
        from molkgnn_torch.graphs.geometric import point_spec_for_graphs

        spec = point_spec_for_graphs(ds.graphs, 8, 5.0)
    model = TModel(TNet(num_layers=1, **SMALL), ffn_dropout_rate=0.0)
    try:
        mesh = None if case == "no mesh" else make_mesh(1, device="cpu")
        with pytest.raises(ValueError, match=message):
            Trainer(model, ds, spec, TrainConfig(**kw), device="cpu",
                    mesh=mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
