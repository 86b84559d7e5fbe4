"""Port parity: model parallelism (halo, hybrid, edge partition) against
the JAX package.

Four ranks (processes started as the port's launcher starts them, gloo on
the CPU) run the port's model-parallel paths once, in a module fixture,
while the parent computes the JAX references on its virtual mesh
(``tests/conftest.py`` gives JAX 8 CPU devices): ``make_mesh(4)`` for halo,
``make_mesh_2d(2, 2)`` for hybrid. JAX is imported inside functions only,
so that the ranks, which import this module, load none of it. The JAX
programs are built from the port's seeded weights (the JAX importer), not
through the JAX Trainer, whose initialisation alone compiles for seconds;
the Trainer's fit and evaluation under halo and hybrid are held against the
port's single-device Trainer, which ``tests/test_torch_port_training.py``
holds against the JAX Trainer.

Tolerances, fp64 on both sides (the JAX batches cast to float64),
tie-free molecules, dropout 0, a 2-layer narrow model: forwards, losses
and gradients within 1e-9; parameters after AdamW steps within the JAX
package's own halo tolerance (rtol 5e-5, atol 1e-6,
``tests/test_parallel.py::_assert_states_close``: the shards reorder the
reductions, and Adam's first steps, near sign(g), amplify that on
near-cancelling elements); metrics within 1e-7 relative; BatchNorm
statistics within 1e-9.
"""

import contextlib
import dataclasses
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from molkgnn_torch.data.dataset import QSAR_METRICS
from molkgnn_torch.data.dataset import Dataset as TDataset
from molkgnn_torch.data.synthetic import tie_free_molgraph
from molkgnn_torch.graphs.batch import batch_graphs as t_batch
from molkgnn_torch.graphs.batch import spec_for_graphs as t_spec
from molkgnn_torch.graphs.device_pack import sample_ids
from molkgnn_torch.models.kgnn import MolKGNNNet as TNet
from molkgnn_torch.parallel import halo, hybrid, launch
from molkgnn_torch.parallel.data_parallel import make_mesh
from molkgnn_torch.training.model import GNNModel as TModel
from molkgnn_torch.training.model import bce_with_logits_loss
from molkgnn_torch.training.optim import fill_missing_grads, make_optimizer
from molkgnn_torch.training.trainer import TRACE_KEYS
from molkgnn_torch.training.trainer import TrainConfig as TConfig
from molkgnn_torch.training.trainer import Trainer as TTrainer

CFG = dict(num_layers=2, kernels_1hop=(2, 3, 2, 3),
           kernels_nhop=(2, 3, 2, 3), graph_embedding_dim=8)
B = 8
N_TRAIN, N_VALID, N_TEST = 32, 12, 4
KW = dict(batch_size=B, max_epochs=1, warmup_iterations=3,
          tot_iterations=10, weight_decay=0.1, progress=False)
ADAM = dict(rtol=5e-5, atol=1e-6)
E9 = dict(rtol=1e-9, atol=1e-9)
BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax", "sklearn", "molkgnn_tpu"}
WORLD = 4


def _graphs():
    """Tie-free molecules with 0/1 labels; both classes in every split."""
    rng = np.random.default_rng(23)
    n = N_TRAIN + N_VALID + N_TEST
    graphs = [tie_free_molgraph(rng) for _ in range(n)]
    for i, g in enumerate(graphs):
        g.y, g.idx = float(i % 3 == 0 or i == n - 1), i
    return graphs


def _split():
    a, b = N_TRAIN, N_TRAIN + N_VALID
    return {"train": np.arange(a), "valid": np.arange(a, b),
            "test": np.arange(b, b + N_TEST)}


def _dataset():
    return TDataset("tie_free", _graphs(), _split(), list(QSAR_METRICS),
                    "bce_with_logits")


def _batches():
    """The two compared batches: train graphs 0-7 and 8-15."""
    graphs = _graphs()
    spec = t_spec(graphs, B)
    return [t_batch(graphs[i * B:(i + 1) * B], spec) for i in range(2)]


def _model(layers=2, seed=7):
    """The port's GNNModel in fp64 from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    enc = TNet(**{**CFG, "num_layers": layers}, generator=gen)
    return TModel(enc, ffn_dropout_rate=0.0, generator=gen).double()


def _trainer(mesh, **kw):
    """The port's Trainer in fp64 on the CPU (device data cast to fp64)."""
    graphs = _graphs()
    tt = TTrainer(_model(), _dataset(), t_spec(graphs, kw.pop("spec_b", B)),
                  TConfig(**{**KW, **kw}), device="cpu", mesh=mesh)
    dd = tt._device_data
    if dd is not None:
        tt._device_data = dataclasses.replace(
            dd, x=dd.x.double(), p=dd.p.double(),
            edge_attr=dd.edge_attr.double(), y=dd.y.double(),
            deg_ea=tuple(a.double() for a in dd.deg_ea))
    return tt


def _state(tt):
    return {k: v.detach().clone() for k, v in tt.model.state_dict().items()}


def _grads(tt, hb):
    """(loss, gradients) of the Trainer's step on ``hb``, reduced, no
    update."""
    loss = tt._loss(hb)
    loss.backward()
    fill_missing_grads(tt._params)
    loss = tt._sync(loss.detach())
    return loss, {n: p.grad.clone() for n, p in tt.model.named_parameters()}


def _first_ids(tt):
    gen = torch.Generator()
    gen.set_state(tt.sample_rng.get_state())
    return sample_ids(gen, *tt._sampler, B)


def _history(tt):
    return [{k: v for k, v in h.items() if k not in TRACE_KEYS}
            for h in tt.history]


# ------------------------------------------------------------ the ranks
def _ranks(out):
    """Every model-parallel scenario on this rank; results to ``out``."""
    torch.set_num_threads(1)
    mesh = make_mesh(WORLD, device="cpu")
    mesh2 = hybrid.make_mesh_2d(2, 2, device="cpu")
    rank = dist.get_rank()
    res = {"modules": sorted(m for m in sys.modules
                             if m.split(".")[0] in BANNED_ROOTS)}
    b0, b1 = _batches()

    # (1) the halo forward at 2 and 3 layers, and the edge partition
    for layers in (2, 3):
        res[f"fwd{layers}"] = halo.halo_parallel_forward(
            _model(layers).gnn_model, halo.partition_halo(b0, WORLD), mesh)
    from molkgnn_torch.parallel import edge_partition

    enc = TNet(**CFG, psum_group=mesh.get_group("data")).double()
    enc.load_state_dict(_model().gnn_model.state_dict())
    res["edge"] = edge_partition.edge_parallel_forward(enc, mesh)(
        edge_partition.partition_batch(b0, WORLD))

    # (2) halo: one step's gradients; 2 steps with pinned capacities, the
    # Trainer's and halo_train_step's
    tt = _trainer(mesh, model_parallel="halo")
    res["halo_grads"] = _grads(tt, tt._mine(tt._partition([b0])))
    res["halo_bn"] = _state(tt)
    tt = _trainer(mesh, model_parallel="halo")
    res["halo_losses"] = [tt._step(tt._mine(tt._partition([b])))
                          for b in (b0, b1)]
    res["halo_caps"] = tt._caps
    res["halo_steps"] = _state(tt)
    model = _model()
    opt = make_optimizer(model, weight_decay=KW["weight_decay"])
    step = halo.halo_train_step(model, opt, mesh, bce_with_logits_loss)
    for b in (b0, b1):
        step(halo.partition_halo(b, WORLD, caps=res["halo_caps"]),
             tt._lr(opt.count))
    res["api_steps"] = {k: v.clone() for k, v in model.state_dict().items()}

    # (3) hybrid 2x2: one step's gradients and its parameters; the forward
    tt = _trainer(mesh2, model_parallel="hybrid")
    part = tt._partition([b0, b1])
    res["hybrid_grads"] = _grads(tt, tt._mine(part))
    tt = _trainer(mesh2, model_parallel="hybrid")
    res["hybrid_loss"] = tt._step(tt._mine(tt._partition([b0, b1])))
    res["hybrid_step"] = _state(tt)
    model = _model()
    opt = make_optimizer(model, weight_decay=KW["weight_decay"])
    hybrid.hybrid_train_step(model, opt, mesh2, bce_with_logits_loss)(
        hybrid.partition_hybrid([b0, b1], 2), tt._lr(opt.count))
    res["api_hybrid"] = {k: v.clone() for k, v in model.state_dict().items()}
    res["hybrid_fwd"] = hybrid.hybrid_parallel_forward(
        _model().gnn_model, hybrid.partition_hybrid([b0, b1], 2), mesh2)

    # (4) device sampling: the first ids and the first step's gradients;
    # a halo epoch against one device's
    for kind, m in (("halo", mesh), ("hybrid", mesh2)):
        tt = _trainer(m, model_parallel=kind, device_sampling=True)
        ids = _first_ids(tt)
        res[f"{kind}_sample_ids"] = ids
        res[f"{kind}_sample_grads"] = _grads(tt, halo.sampled_halo_batch(
            tt._device_data, ids, tt._shard_spec, tt._gather,
            tt._mp.n_model, tt._mp.index))
        tt = _trainer(m, model_parallel=kind, device_sampling=True,
                      log_dir=os.path.join(out, kind))
        tt.fit()
        res[f"{kind}_sample_fit"] = (tt.step, _state(tt))

    # (5) Trainer fit, evaluate, test and embeddings on halo, the pinned
    # capacities grown from a tiny start; hybrid fit
    root = os.path.join(out, f"halo_fit{rank}")
    tt = _trainer(mesh, model_parallel="halo", log_dir=root)
    tt._caps = {**halo.partition_halo(b0, WORLD).caps(), "el": 8, "eh": 8,
                "buckets": (8,) * 4}
    tt.fit()
    res["halo_fit"] = (tt.step, _history(tt), _state(tt), tt._caps)
    res["halo_eval"] = tt._predictions("valid")
    res["halo_test"] = tt.test()
    tt.save_graph_embedding(root)
    tt = _trainer(mesh2, model_parallel="hybrid",
                  log_dir=os.path.join(out, "hybrid_fit"))
    tt.fit()
    res["hybrid_fit"] = (tt.step, _history(tt), _state(tt))
    res["hybrid_eval"] = tt._predictions("valid")

    # (6) the single-device references (rank 0; the device-data path,
    # whose batches are the host loader's: test_torch_port_training.py)
    if rank == 0:
        one = _trainer(None, log_dir=os.path.join(out, "one"))
        one.fit()
        res["one_fit"] = (one.step, _history(one), _state(one))
        res["one_test"] = one.test()
        one = _trainer(None, device_sampling=True,
                       log_dir=os.path.join(out, "one_sample"))
        res["one_sample_ids"] = _first_ids(one)
        one.fit()
        res["one_sample_fit"] = (one.step, _state(one))
        one = _trainer(None, batch_size=2 * B, spec_b=2 * B,
                       log_dir=os.path.join(out, "one16"))
        one.fit()
        res["one16_fit"] = (one.step, _history(one), _state(one))
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


# ------------------------------------------------------------ fixtures
@contextlib.contextmanager
def _x64():
    import jax

    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _jax_graphs(graphs):
    from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph

    out = []
    for g in graphs:
        jg = JMolGraph(x=g.x, p=g.p, edge_index=g.edge_index,
                       edge_attr=g.edge_attr, y=g.y, atomic_num=g.atomic_num)
        jg.idx = g.idx
        out.append(jg.with_fields())
    return out


def _sample_batch_ids():
    """The device samplers' first ids, drawn as the ranks draw them: halo
    on the single-device stream, hybrid a stream per data group."""
    from molkgnn_torch.data.dataset import oversampling_weights
    from molkgnn_torch.graphs.device_pack import alias_sampler
    from molkgnn_torch.parallel.data_parallel import sampler_seed
    from molkgnn_torch.training.trainer import SAMPLE_SALT

    graphs = _graphs()
    train = _split()["train"]
    table = alias_sampler(oversampling_weights(
        np.array([graphs[i].y for i in train])))
    sampler = (torch.from_numpy(table.prob), torch.from_numpy(table.alias),
               torch.from_numpy(train.astype(np.int32)))

    def draw(stream):
        gen = torch.Generator().manual_seed(
            sampler_seed(42, SAMPLE_SALT, stream))
        return sample_ids(gen, *sampler, B).numpy()

    return draw(None), np.concatenate([draw(0), draw(1)])


def _jax_references():
    """The JAX package's programs on the port's weights, in fp64."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from molkgnn_tpu.graphs import batch_graphs as j_batch
    from molkgnn_tpu.graphs import spec_for_graphs as j_spec
    from molkgnn_tpu.models import MolKGNNNet as JNet
    from molkgnn_tpu.parallel import halo as j_halo
    from molkgnn_tpu.parallel import hybrid as j_hybrid
    from molkgnn_tpu.parallel import make_mesh as j_mesh
    from molkgnn_tpu.training import GNNModel as JModel
    from molkgnn_tpu.training import checkpoint as j_ckpt
    from molkgnn_tpu.training.model import bce_with_logits_loss as j_bce
    from molkgnn_tpu.training.optim import make_optimizer as j_optimizer
    from molkgnn_tpu.training.schedule import polynomial_warmup_decay
    from molkgnn_tpu.training.trainer import TrainState

    def f64(tree):
        return jax.tree.map(
            lambda a: np.asarray(a, np.float64)
            if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)

    out = {}
    graphs = _jax_graphs(_graphs())
    spec = j_spec(graphs, B)
    b0, b1 = (j_batch(graphs[i * B:(i + 1) * B], spec) for i in range(2))
    # Every gradient reference is one program: batches of 8 graphs are
    # packed under the spec of 16 (the rest masked).
    spec2 = j_spec(graphs, 2 * B)
    mesh = j_mesh(WORLD)
    # Both batches under one set of capacities: one forward program.
    caps = j_hybrid.partition_hybrid([b0, b1], WORLD).caps()
    with _x64():
        variables = {}
        for layers in (2, 3):
            jmodel = JModel(encoder=JNet(**{**CFG, "num_layers": layers}),
                            ffn_dropout_rate=0.0)
            template = jax.tree.map(
                lambda a: np.zeros(a.shape, a.dtype),
                jax.eval_shape(jmodel.init, jax.random.key(0), b0))
            v = f64(j_ckpt.from_torch_state_dict(
                template, _model(layers).state_dict()))
            variables[layers] = (jmodel, v)
            enc_v = {"params": v["params"]["encoder"],
                     "batch_stats": v["batch_stats"]["encoder"]}
            forward = j_halo.halo_parallel_forward(jmodel.encoder, mesh)
            out[f"fwd{layers}"] = [
                np.asarray(forward(enc_v, f64(j_halo.partition_halo(
                    b, WORLD, caps=caps))))
                for b in ((b0, b1) if layers == 2 else (b0,))]
        jmodel, v = variables[2]

        def loss_fn(params, stats, batch):
            (pred, _), up = jmodel.apply(
                {"params": params, "batch_stats": stats}, batch, train=True,
                rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
            return j_bce(pred, batch.y, batch.graph_mask), up

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

        def grads(batch):
            (loss, up), g = grad_fn(v["params"], v["batch_stats"],
                                    f64(batch))
            return float(loss), jax.device_get(g), jax.device_get(up)

        out["grads"] = grads(j_batch(graphs[:B], spec2))
        halo_ids, hybrid_ids = _sample_batch_ids()
        out["sample_grads"] = grads(j_batch([graphs[i] for i in halo_ids],
                                            spec2))
        out["hybrid_sample_grads"] = grads(
            j_batch([graphs[i] for i in hybrid_ids], spec2))
        out["hybrid_grads"] = grads(j_batch(graphs[:2 * B], spec2))

        schedule = polynomial_warmup_decay(
            peak_lr=5e-3, end_lr=1e-10, warmup_iterations=KW[
                "warmup_iterations"], tot_iterations=KW["tot_iterations"])
        tx = j_optimizer(v["params"], schedule,
                         weight_decay=KW["weight_decay"])

        def state(mesh):
            """Replicated over ``mesh`` as the step returns it, so that the
            second step reuses the first's program."""
            return jax.device_put(TrainState(
                step=jnp.asarray(0, jnp.int32), params=v["params"],
                batch_stats=v["batch_stats"],
                opt_state=tx.init(v["params"]), rng=jax.random.key(0)),
                NamedSharding(mesh, P()))

        widen = {**j_halo.partition_halo(b0, WORLD).caps()}
        w = lambda x: int(-(-int(x * 1.5) // 8) * 8)  # noqa: E731
        caps = {"ns": widen["ns"], "hp": w(widen["hp"]),
                "el": w(widen["el"]), "eh": w(widen["eh"]),
                "buckets": tuple(w(b) for b in widen["buckets"])}
        out["caps"] = caps
        halo_step = j_halo.halo_train_step(jmodel, tx, mesh)
        st, losses = state(mesh), []
        for b in (b0, b1):
            st, loss = halo_step(st, f64(j_halo.partition_halo(
                b, WORLD, caps=caps)))
            losses.append(float(loss))
        out["halo_steps"] = (losses, jax.device_get(
            {"params": st.params, "batch_stats": st.batch_stats}))

        mesh2 = j_hybrid.make_mesh_2d(2, 2)
        part = f64(j_hybrid.partition_hybrid([b0, b1], 2))
        st, loss = j_hybrid.hybrid_train_step(jmodel, tx, mesh2)(
            state(mesh2), part)
        out["hybrid_step"] = (float(loss), jax.device_get(
            {"params": st.params, "batch_stats": st.batch_stats}))
        out["ids"] = (halo_ids, hybrid_ids)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the JAX references, the output directory)."""
    out = tmp_path_factory.mktemp("mp")
    ctx = torch.multiprocessing.start_processes(
        launch._rank_main,
        args=(WORLD, launch.free_port(), "cpu", "gloo", _ranks, (str(out),)),
        nprocs=WORLD, join=False, start_method="spawn")
    jax_out = _jax_references()
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the model-parallel ranks did not finish")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return ranks, jax_out, out


def _port_names(variables):
    from molkgnn_torch.training.checkpoint import from_jax_variables

    return from_jax_variables(variables)


def _assert_grads(got, want_tree):
    """Port gradients by parameter name against a JAX gradient tree."""
    want = _port_names({"params": want_tree, "batch_stats": {}})
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                   **E9)


def _assert_state(got, variables, **tol):
    """Parameters within ``tol``; BatchNorm statistics within 1e-9."""
    want = _port_names(variables)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), err_msg=k,
            **(E9 if "running" in k else tol))


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        torch.testing.assert_close(r[key], first, rtol=0, atol=0)
    return first


# ------------------------------------------------------------ the tests
def test_ranks_import_no_jax(runs):
    """A spawned rank (the launcher, this module, the port) loads none of
    jax, flax, optax, scikit-learn or the JAX package."""
    ranks, _, _ = runs
    assert [r["modules"] for r in ranks] == [[]] * WORLD


@pytest.mark.parametrize("layers", [2, 3])
def test_halo_forward_matches_jax(runs, layers):
    """(1) The halo forward over 4 shards against the JAX package's
    halo_parallel_forward, pooled embeddings within 1e-9."""
    ranks, jax_out, _ = runs
    got = _same_on_every_rank(ranks, f"fwd{layers}")
    np.testing.assert_allclose(got.numpy(), jax_out[f"fwd{layers}"][0],
                               **E9)


def test_edge_partition_forward_matches_jax(runs):
    """(1) The edge-partition baseline (psum_group over 4 ranks) equals the
    JAX halo forward of the same weights and batch within 1e-9."""
    ranks, jax_out, _ = runs
    got = _same_on_every_rank(ranks, "edge")
    np.testing.assert_allclose(got.numpy(), jax_out["fwd2"][0], **E9)


def test_halo_step_gradients_match_jax(runs):
    """(2) One halo step's loss and gradients (4 shards, the mean of the
    shards' gradients through both exchanges and the pooled sum) against
    jax.grad on the whole batch on one device, within 1e-9; the BatchNorm
    statistics after the step's forward too."""
    ranks, jax_out, _ = runs
    loss, grads, up = jax_out["grads"]
    for r in ranks:
        got_loss, got = r["halo_grads"]
        np.testing.assert_allclose(float(got_loss), loss, **E9)
        _assert_grads(got, grads)
    want = _port_names({"params": grads, "batch_stats": up["batch_stats"]})
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(ranks[0]["halo_bn"][k].numpy(),
                                       w.numpy(), err_msg=k, **E9)


def test_halo_steps_with_pinned_caps_match_jax(runs):
    """(2) Two Trainer steps over 4 shards with the pinned capacities
    (the JAX Trainer's widening of the first batch's) against the JAX
    package's halo_train_step; halo_train_step's port gives the same
    parameters as the Trainer's step."""
    ranks, jax_out, _ = runs
    losses, variables = jax_out["halo_steps"]
    for r in ranks:
        assert r["halo_caps"] == jax_out["caps"]
        np.testing.assert_allclose([float(x) for x in r["halo_losses"]],
                                   losses, **E9)
    state = _same_on_every_rank(ranks, "halo_steps")
    _assert_state(state, variables, **ADAM)
    for k, v in ranks[0]["api_steps"].items():
        torch.testing.assert_close(v, state[k], rtol=1e-12, atol=1e-12)


def test_hybrid_step_matches_jax(runs):
    """(3) A 2x2 hybrid step (two data groups of 2 shards) against the
    JAX package's hybrid_train_step: the global loss, the gradients
    (equal to one device's on the undivided batch of 16) and the
    parameters after the update; hybrid_train_step's port gives the
    Trainer's parameters."""
    ranks, jax_out, _ = runs
    loss, variables = jax_out["hybrid_step"]
    one_loss, grads, _ = jax_out["hybrid_grads"]
    np.testing.assert_allclose(one_loss, loss, **E9)
    for r in ranks:
        np.testing.assert_allclose(float(r["hybrid_loss"]), loss, **E9)
        np.testing.assert_allclose(float(r["hybrid_grads"][0]), loss, **E9)
        _assert_grads(r["hybrid_grads"][1], grads)
    state = _same_on_every_rank(ranks, "hybrid_step")
    _assert_state(state, variables, **ADAM)
    for k, v in ranks[0]["api_hybrid"].items():
        torch.testing.assert_close(v, state[k], rtol=1e-12, atol=1e-12)


def test_hybrid_forward_matches_jax(runs):
    """(3) hybrid_parallel_forward: both groups' pooled embeddings
    [2, B, H] on every rank, within 1e-9 of the JAX package's halo
    forward of each group's batch (what its hybrid forward runs on each
    row of the mesh)."""
    ranks, jax_out, _ = runs
    got = _same_on_every_rank(ranks, "hybrid_fwd")
    assert got.shape == (2, B, CFG["graph_embedding_dim"])
    np.testing.assert_allclose(got.numpy(), np.stack(jax_out["fwd2"]),
                               **E9)


@pytest.mark.parametrize("kind", ["halo", "hybrid"])
def test_device_sampled_first_step_matches_jax(runs, kind):
    """(4) Device sampling: halo ranks draw the single-device stream's
    ids, a hybrid data group its own stream's (the ranks of a row agree);
    the first step's loss and gradients (empty-cut shards assembled on the
    device) equal jax.grad on one device over the whole drawn batch (16
    graphs under hybrid) within 1e-9."""
    ranks, jax_out, _ = runs
    halo_ids, hybrid_ids = jax_out["ids"]
    if kind == "halo":
        for r in ranks:
            np.testing.assert_array_equal(r["halo_sample_ids"].numpy(),
                                          halo_ids)
        np.testing.assert_array_equal(ranks[0]["one_sample_ids"].numpy(),
                                      halo_ids)
        loss, grads, _ = jax_out["sample_grads"]
    else:
        for rank, r in enumerate(ranks):
            group = rank // 2
            np.testing.assert_array_equal(
                r["hybrid_sample_ids"].numpy(),
                hybrid_ids[group * B:(group + 1) * B])
        loss, grads, _ = jax_out["hybrid_sample_grads"]
    for r in ranks:
        got_loss, got = r[f"{kind}_sample_grads"]
        np.testing.assert_allclose(float(got_loss), loss, **E9)
        _assert_grads(got, grads)


def test_device_sampled_epochs(runs):
    """(4) A device-sampled halo epoch takes ceil(32 / 8) = 4 steps and
    ends where one device's device-sampled epoch ends; a hybrid epoch
    takes 4 // 2 = 2 steps; every rank ends equal."""
    ranks, _, _ = runs
    step, state = ranks[0]["halo_sample_fit"]
    one_step, one = ranks[0]["one_sample_fit"]
    assert step == one_step == 4
    for k, v in one.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k,
                                   **ADAM)
    for kind, steps in (("halo", 4), ("hybrid", 2)):
        first = ranks[0][f"{kind}_sample_fit"]
        for r in ranks[1:]:
            assert r[f"{kind}_sample_fit"][0] == first[0] == steps
            for k, v in r[f"{kind}_sample_fit"][1].items():
                assert torch.equal(v, first[1][k]), k


def _assert_history(got, want):
    assert len(got) == len(want)
    for h, w in zip(got, want):
        assert set(h) == set(w)
        for k, v in w.items():
            np.testing.assert_allclose(h[k], v, rtol=1e-7, atol=1e-9,
                                       err_msg=k)


def test_halo_fit_evaluate_test_match_one_device(runs):
    """(5) Trainer.fit + test under halo (host-fed: every rank the whole
    batch, 4 steps) from tiny pinned capacities that grow at the first
    batch, against the single-device host-loader Trainer: the history, the
    parameters and the test metrics; every rank gets every prediction;
    rank 0 alone writes the embeddings."""
    ranks, _, out = runs
    step, hist, state, caps = ranks[0]["halo_fit"]
    one_step, one_hist, one = ranks[0]["one_fit"]
    assert step == one_step == N_TRAIN // B
    assert caps["el"] > 8 and min(caps["buckets"]) > 8  # grown
    _assert_history(hist, one_hist)
    for k, v in one.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k,
                                   **ADAM)
    for r in ranks[1:]:
        assert r["halo_fit"][0] == step and r["halo_fit"][3] == caps
        np.testing.assert_array_equal(r["halo_eval"][1],
                                      ranks[0]["halo_eval"][1])
    assert len(ranks[0]["halo_eval"][1]) == N_VALID
    for tag, metrics in ranks[0]["one_test"].items():
        for k, v in metrics.items():
            np.testing.assert_allclose(ranks[0]["halo_test"][tag][k], v,
                                       rtol=1e-7, atol=1e-9)
    emb = np.load(out / "halo_fit0" / "graph_embedding.npy")
    assert emb.shape == (N_TEST, CFG["graph_embedding_dim"])
    assert not (out / "halo_fit1").exists()


def test_hybrid_fit_matches_one_device_at_twice_the_batch(runs):
    """(5) Trainer.fit under hybrid 2x2 (a step takes 2 loader batches of
    8: 2 steps) against the single-device host-loader Trainer at batch 16
    (the same draws, the same steps); evaluation's predictions on every
    rank."""
    ranks, _, _ = runs
    step, hist, state = ranks[0]["hybrid_fit"]
    one_step, one_hist, one = ranks[0]["one16_fit"]
    assert step == one_step == N_TRAIN // (2 * B)
    _assert_history(hist, one_hist)
    for k, v in one.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k,
                                   **ADAM)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["hybrid_eval"][1],
                                      ranks[0]["hybrid_eval"][1])
    assert len(ranks[0]["hybrid_eval"][1]) == N_VALID
