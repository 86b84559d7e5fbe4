"""Port parity: data parallel on torch.distributed against the JAX package.

Two ranks (processes started with the port's launcher, gloo on the CPU)
run the port's data-parallel paths; the JAX package runs its own on a
2-device virtual mesh (``tests/conftest.py`` gives JAX 8 CPU devices),
from the same weights (``from_jax_variables``) and the same ids. The ranks
run once, in a module fixture, while the parent computes the JAX
references; each test reads its part. JAX is imported inside functions
only, so that the ranks, which import this module, load none of it.

Tolerances: fp64 (JAX with jax_enable_x64, the port in double) on
tie-free molecules, dropout 0, a 2-layer narrow model: losses, BatchNorm
statistics and predictions within 1e-9; parameters after AdamW steps and
metrics within 1e-7 relative, as ``tests/test_torch_port_training.py``
holds them (optax computes Adam's bias corrections in fp32 from its int32
count, which moves each update by ~1e-8 of itself). The SchNet step runs
the JAX SchNet with its products in float64 (its layers ask for float32),
as ``tests/test_torch_port_point_models.py`` does. Port against port
(world 2 against one device, a resumed run against an uninterrupted one):
bit for bit, or 1e-6 for fp32 scores from another process.
"""

import contextlib
import dataclasses
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from molkgnn_torch.data.dataset import QSAR_METRICS
from molkgnn_torch.data.dataset import Dataset as TDataset
from molkgnn_torch.data.synthetic import random_dataset, tie_free_molgraph
from molkgnn_torch.graphs import geometric as t_geo
from molkgnn_torch.graphs.batch import spec_for_graphs as t_spec
from molkgnn_torch.graphs.device_pack import sample_ids
from molkgnn_torch.models.kgnn import MolKGNNNet as TNet
from molkgnn_torch.models.schnet import SchNet
from molkgnn_torch.parallel import launch, multihost
from molkgnn_torch.parallel.data_parallel import make_mesh, rank_rows
from molkgnn_torch.serving.predictor import Predictor
from molkgnn_torch.training.model import GNNModel as TModel
from molkgnn_torch.training.trainer import TRACE_KEYS
from molkgnn_torch.training.trainer import TrainConfig as TConfig
from molkgnn_torch.training.trainer import Trainer as TTrainer

CFG = dict(
    num_layers=2, kernels_1hop=(2, 3, 2, 3), kernels_nhop=(2, 3, 2, 3),
    graph_embedding_dim=8,
)
B = 8
N_TRAIN, N_VALID, N_TEST = 40, 20, 4  # 5 train batches: 2 steps of 2
KW = dict(
    batch_size=B, max_epochs=1, warmup_iterations=3, weight_decay=0.1,
    grad_clip_norm=2.0, skip_nonfinite_updates=True, progress=False,
)
R64 = dict(rtol=1e-7, atol=1e-9)
SCHNET = dict(num_layers=2, num_filters=16, num_gaussians=10,
              hidden_channels=16, out_channels=8)
CUTOFF = 3.5
SCHNET_B = 4
BANNED_ROOTS = {"jax", "jaxlib", "flax", "optax", "sklearn", "molkgnn_tpu"}


def _graphs():
    """Tie-free molecules with 0/1 labels; both classes in every split."""
    rng = np.random.default_rng(5)
    n = N_TRAIN + N_VALID + N_TEST
    graphs = [tie_free_molgraph(rng) for _ in range(n)]
    for i, g in enumerate(graphs):
        g.y, g.idx = float(i % 3 == 0 or i == n - 1), i
    return graphs


def _split():
    a, b = N_TRAIN, N_TRAIN + N_VALID
    n = b + N_TEST
    return {"train": np.arange(a), "valid": np.arange(a, b),
            "test": np.arange(b, n)}


def _step_ids():
    """The two ranks' ids of the compared step."""
    rng = np.random.default_rng(0)
    ids = rng.choice(N_TRAIN, 2 * B, replace=False).astype(np.int32)
    return ids[:B], ids[B:]


def _schnet_graphs():
    out = random_dataset(seed=11, num_graphs=2 * SCHNET_B)
    for g in out:
        k = min(g.num_nodes, 12)
        g.x, g.p, g.atomic_num = g.x[:k], g.p[:k], g.atomic_num[:k]
        g.edge_index = np.zeros((2, 0), np.int32)
        g.edge_attr = np.zeros((0, 7), np.float32)
        g.fields = None
        g.y = float(g.num_nodes % 2)
    return out


def _dataset(graphs):
    return TDataset("tie_free", graphs, _split(), list(QSAR_METRICS),
                    "bce_with_logits")


def _trainer(weights, mesh=None, **kw):
    """The port's kgnn Trainer in fp64 on the CPU from ``weights``."""
    graphs = _graphs()
    model = TModel(TNet(**CFG), ffn_dropout_rate=0.0).double()
    model.load_state_dict(weights, strict=True)
    tt = TTrainer(model, _dataset(graphs), t_spec(graphs, B),
                  TConfig(**{**KW, **kw}), device="cpu", mesh=mesh)
    dd = tt._device_data
    tt._device_data = dataclasses.replace(
        dd, x=dd.x.double(), p=dd.p.double(),
        edge_attr=dd.edge_attr.double(), y=dd.y.double(),
        deg_ea=tuple(a.double() for a in dd.deg_ea),
    )
    return tt


def _state(tt):
    return {k: v.clone() for k, v in tt.model.state_dict().items()}


# ------------------------------------------------------------ the ranks
def _ranks(out):
    """Every data-parallel scenario on this rank; results to ``out``."""
    torch.set_num_threads(2)
    mesh = make_mesh(2, device="cpu")
    rank = dist.get_rank()
    weights = torch.load(os.path.join(out, "weights.pt"))

    def save(name, obj):
        torch.save(obj, os.path.join(out, f"{name}_{rank}.pt"))

    save("modules", sorted(m for m in sys.modules
                           if m.split(".")[0] in BANNED_ROOTS))

    # (1) one step on this rank's batch
    tt = _trainer(weights["kgnn"], mesh)
    loss = tt._step_ids(_step_ids()[rank])
    save("step", {"loss": loss, "state": _state(tt)})

    # (3) evaluation of the ragged valid split (3 blocks on 2 ranks)
    true, pred = _trainer(weights["kgnn"], mesh)._predict_ids(
        _split()["valid"])
    save("eval", {"true": torch.from_numpy(true),
                  "pred": torch.from_numpy(pred)})

    # (2) one epoch of fit on the device-data path
    tt = _trainer(weights["kgnn"], mesh, log_dir=os.path.join(out, "fit"))
    history = tt.fit()
    save("fit", {"history": [{k: v for k, v in h.items()
                              if k not in TRACE_KEYS} for h in history],
                 "step": tt.step, "state": _state(tt)})

    # (4) screening at world 2, two slabs with ragged block counts
    graphs = _graphs()
    model = TModel(TNet(**CFG), ffn_dropout_rate=0.0)
    model.load_state_dict(weights["kgnn"])
    pred = Predictor(model, model.state_dict(), t_spec(graphs, B),
                     device="cpu").screen_library(graphs, slab=36, mesh=mesh)
    save("screen", {"scores": torch.from_numpy(pred)})

    # (5) device sampling: 2 epochs; this rank's first ids
    tt = _trainer(weights["kgnn"], mesh, device_sampling=True, max_epochs=2,
                  log_dir=os.path.join(out, "sample"))
    gen = torch.Generator()
    gen.set_state(tt.sample_rng.get_state())
    first = sample_ids(gen, *tt._sampler, B)
    tt.fit()
    save("sample", {"first": first, "step": tt.step, "state": _state(tt)})

    # (6) fewer batches than ranks
    try:
        _trainer(weights["kgnn"], mesh, batch_size=64,
                 log_dir=os.path.join(out, "few")).fit()
        message = ""
    except ValueError as e:
        message = str(e)
    save("few", {"message": message})

    # (7) the helpers in a world of 2
    save("multihost", {
        "shard": multihost.host_shard(list(range(10))),
        "rows": torch.from_numpy(multihost.local_device_batches(
            np.arange(6).reshape(2, 3))),
    })

    # (9) SchNet, one step on this rank's batch
    sgraphs = _schnet_graphs()
    sspec = t_geo.point_spec_for_graphs(sgraphs, SCHNET_B, CUTOFF)
    smodel = TModel(SchNet(cutoff=CUTOFF, **SCHNET),
                    ffn_dropout_rate=0.0).double()
    smodel.load_state_dict(weights["schnet"], strict=True)
    st = TTrainer(smodel, TDataset("schnet", sgraphs, _split_schnet(),
                                   list(QSAR_METRICS), "bce_with_logits"),
                  sspec,
                  TConfig(**{**KW, "batch_size": SCHNET_B,
                             "use_device_data": False}),
                  device="cpu", mesh=mesh)
    batch = t_geo.batch_points(
        sgraphs[rank * SCHNET_B:(rank + 1) * SCHNET_B], sspec)
    loss = st._step(dataclasses.replace(batch, pos=batch.pos.double(),
                                        y=batch.y.double()))
    save("schnet", {"loss": loss, "state": _state(st)})

    # (10) rank-0 writes, resume, and a stop signal on rank 0 only
    import molkgnn_torch.training.trainer as trainer_mod

    writes = []
    real_save, real_open = torch.save, open

    def counted_save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):  # not all_gather_object's
            writes.append(str(f))
        return real_save(obj, f, *a, **k)

    def counted_open(path, mode="r", *a, **k):
        if "w" in mode or "a" in mode:
            writes.append(str(path))
        return real_open(path, mode, *a, **k)

    def run(tag, epochs, monitor=None):
        root = os.path.join(out, tag)
        t = _trainer(weights["kgnn"], mesh, device_sampling=True,
                     max_epochs=epochs, log_dir=os.path.join(root, "logs"),
                     checkpoint_dir=os.path.join(root, "ckpt"),
                     autosave_path=os.path.join(root, "autosave"))
        t.monitor = monitor
        t.fit()
        return t

    class StopAfterSecondEpoch:
        def on_epoch_end(self, epoch, results):
            if epoch == 1:
                os.kill(os.getpid(), signal.SIGTERM)

    torch.save, trainer_mod.open = counted_save, counted_open
    try:
        stopped = run("resumed", 3,
                      StopAfterSecondEpoch() if rank == 0 else None)
    finally:
        torch.save, trainer_mod.open = real_save, real_open
    resumed = run("resumed", 3)
    whole = run("whole", 3)
    save("resume", {"writes": writes, "resumed": _state(resumed),
                    "whole": _state(whole), "losses": resumed.step_losses,
                    "whole_losses": whole.step_losses,
                    "stopped_epochs": len(stopped.history)})


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
        out.append(jg.with_fields() if g.edge_index.shape[1] else jg)
    return out


class _Float64Products:
    """The JAX SchNet module's ``jnp`` with ``dot`` in the inputs' dtype."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return getattr(jnp, name)

    @staticmethod
    def dot(a, b, preferred_element_type=None):
        import jax.numpy as jnp

        return jnp.dot(a, b)


def _jax_references(weights_out):
    """The JAX package's DP runs on a 2-device mesh, in fp64; writes the
    shared initial weights first (``weights_out``) so the ranks can
    start."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from molkgnn_tpu.data.dataset import Dataset as JDataset
    from molkgnn_tpu.graphs import spec_for_graphs as j_spec
    from molkgnn_tpu.graphs import geometric as j_geo
    from molkgnn_tpu.graphs.device_pack import gather_batch as j_gather
    from molkgnn_tpu.models import MolKGNNNet as JNet
    from molkgnn_tpu.models import schnet as j_schnet
    from molkgnn_tpu.parallel import make_mesh as j_mesh
    from molkgnn_tpu.parallel import stack_shards
    from molkgnn_tpu.training import GNNModel as JModel
    from molkgnn_tpu.training import TrainConfig as JConfig
    from molkgnn_tpu.training import Trainer as JTrainer
    from molkgnn_tpu.training import checkpoint as j_ckpt
    from molkgnn_torch.training.checkpoint import from_jax_variables

    def f64(tree):
        return jax.tree.map(
            lambda a: a.astype(jnp.float64)
            if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)

    def copy(state):
        return jax.tree.map(lambda a: a.copy(), state)

    def variables(state):
        return jax.device_get({"params": state.params,
                               "batch_stats": state.batch_stats})

    def to64(jt):
        params = f64(jt.state.params)
        jt.state = jt.state.replace(
            params=params, batch_stats=f64(jt.state.batch_stats),
            opt_state=jt.tx.init(params))

    graphs = _graphs()
    jgraphs = _jax_graphs(graphs)
    jds = JDataset("tie_free", jgraphs, _split(), list(QSAR_METRICS),
                   "bce_with_logits")
    jspec = j_spec(jgraphs, B)
    mesh = j_mesh(2)

    # SchNet: the port's seeded weights through the JAX importer
    sgraphs = _schnet_graphs()
    jsgraphs = _jax_graphs(sgraphs)
    jsspec = j_geo.point_spec_for_graphs(jsgraphs, SCHNET_B, CUTOFF)
    jsmodel = JModel(encoder=j_schnet.SchNet(cutoff=CUTOFF, **SCHNET),
                     ffn_dropout_rate=0.0)
    jsb = [j_geo.batch_points(jsgraphs[r * SCHNET_B:(r + 1) * SCHNET_B],
                              jsspec) for r in range(2)]
    template = jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jax.eval_shape(jsmodel.init, jax.random.key(0), jsb[0]))
    gen = torch.Generator().manual_seed(7)
    smodel = TModel(SchNet(cutoff=CUTOFF, generator=gen, **SCHNET),
                    ffn_dropout_rate=0.0, generator=gen)
    sv = j_ckpt.from_torch_state_dict(template, smodel.state_dict())

    with _x64():
        jt = JTrainer(JModel(encoder=JNet(**CFG), ffn_dropout_rate=0.0),
                      jds, jspec, JConfig(**KW, log_dir=os.path.join(
                          os.path.dirname(weights_out), "jax_logs")),
                      mesh=mesh)
        v0 = variables(jt.state)
        torch.save({"kgnn": from_jax_variables(v0),
                    "schnet": from_jax_variables(sv)}, weights_out)
        yield  # the ranks start here
        to64(jt)
        jt._device_data = f64(jt._device_data)
        # Replicated as fit() leaves it, so that evaluation compiles once.
        jt.state = jax.device_put(jt.state, NamedSharding(mesh, P()))
        state0 = copy(jt.state)
        out = {"v0": v0}

        ids = _step_ids()
        stacked = stack_shards([j_gather(jt._device_data, jnp.asarray(i),
                                         jspec) for i in ids])
        st, loss = jt._train_step(copy(state0), stacked)
        out["step"] = (float(loss), variables(st))

        true, pred = jt._predict_ids(_split()["valid"])
        out["eval"] = (np.asarray(true), np.asarray(pred))

        history = jt.fit()
        out["fit"] = (history, int(jt.state.step), variables(jt.state))

        jst = JTrainer(jsmodel, JDataset(
            "schnet", jsgraphs, _split_schnet(), list(QSAR_METRICS),
            "bce_with_logits"), jsspec,
            JConfig(**{**KW, "batch_size": SCHNET_B}), mesh=mesh,
            collate=j_geo.batch_points)
        sparams = f64(jax.tree.map(jnp.asarray, sv["params"]))
        jst.state = jst.state.replace(params=sparams,
                                      opt_state=jst.tx.init(sparams))
        saved = j_schnet.jnp
        j_schnet.jnp = _Float64Products()
        try:
            batches = [dataclasses.replace(
                b, pos=np.asarray(b.pos, np.float64),
                y=np.asarray(b.y, np.float64)) for b in jsb]
            st, loss = jst._train_step(copy(jst.state), stack_shards(batches))
        finally:
            j_schnet.jnp = saved
        out["schnet"] = (float(loss), jax.device_get({"params": st.params}))
    yield out  # (the generator is closed, leaving x64, after this)


def _split_schnet():
    n = 2 * SCHNET_B
    return {"train": np.arange(n), "valid": np.arange(n),
            "test": np.arange(n)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results by scenario, the JAX references)."""
    out = tmp_path_factory.mktemp("dp")
    refs = _jax_references(str(out / "weights.pt"))
    next(refs)
    ctx = torch.multiprocessing.start_processes(
        launch._rank_main,
        args=(2, launch.free_port(), "cpu", "gloo", _ranks, (str(out),)),
        nprocs=2, join=False, start_method="spawn")
    jax_out = next(refs)
    refs.close()
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the data-parallel ranks did not finish")

    def load(name):
        return [torch.load(out / f"{name}_{r}.pt", weights_only=False)
                for r in range(2)]

    return load, jax_out, out


def _assert_state(got, variables, **tol):
    """Parameters within ``tol``; BatchNorm statistics within 1e-9."""
    from molkgnn_torch.training.checkpoint import from_jax_variables

    want = from_jax_variables(variables)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), err_msg=k,
            **(dict(rtol=1e-9, atol=1e-12) if "running" in k else tol))


# ------------------------------------------------------------ the tests
def test_ranks_import_no_jax(runs):
    """A spawned rank (the launcher, this module, the port) loads none of
    jax, flax, optax, scikit-learn or the JAX package."""
    load, _, _ = runs
    assert load("modules") == [[], []]


def test_dp_step_matches_jax(runs):
    """(1) One step on two ranks, each on its own batch, against the JAX
    Trainer's DP step on ``stack_shards([b0, b1])``: the mean loss, the
    averaged BatchNorm statistics and the parameters; both ranks equal."""
    load, jax_out, _ = runs
    r0, r1 = load("step")
    loss, variables = jax_out["step"]
    for r in (r0, r1):
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=1e-9)
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert any("running" in k for k in r0["state"])
    _assert_state(r0["state"], variables, **R64)


def test_dp_fit_epoch_matches_jax(runs):
    """(2) One epoch of fit() on the device-data path against the JAX DP
    fit: 5 batches, 2 steps of 2 (the trailing batch dropped), the same
    history and final weights."""
    load, jax_out, _ = runs
    r0, r1 = load("fit")
    history, jstep, variables = jax_out["fit"]
    assert r0["step"] == r1["step"] == jstep == 2
    (h,) = r0["history"]
    assert list(h) == list(r1["history"][0])
    np.testing.assert_array_equal(list(h.values()),
                                  list(r1["history"][0].values()))
    for k, v in h.items():
        np.testing.assert_allclose(v, history[0][k], err_msg=k, **R64)
    _assert_state(r0["state"], variables, **R64)


def test_dp_evaluation_matches_single_device_and_jax(runs):
    """(3) The valid split's 3 blocks on 2 ranks (padded to 4) against the
    port on one device and the JAX DP evaluation; both ranks get every
    prediction."""
    load, jax_out, _ = runs
    r0, r1 = load("eval")
    assert torch.equal(r0["pred"], r1["pred"])
    single = _trainer(_weights(jax_out))
    true, pred = single._predict_ids(_split()["valid"])
    assert len(pred) == N_VALID and -(-N_VALID // B) % 2
    np.testing.assert_array_equal(r0["true"].numpy(), true)
    np.testing.assert_allclose(r0["pred"].numpy(), pred, rtol=1e-12,
                               atol=1e-12)
    jtrue, jpred = jax_out["eval"]
    np.testing.assert_array_equal(jtrue, true)
    np.testing.assert_allclose(r0["pred"].numpy(), jpred, rtol=1e-9,
                               atol=1e-9)


def _weights(jax_out):
    from molkgnn_torch.training.checkpoint import from_jax_variables

    return from_jax_variables(jax_out["v0"])


def _screen_single(jax_out, mesh=None):
    graphs = _graphs()
    model = TModel(TNet(**CFG), ffn_dropout_rate=0.0)
    model.load_state_dict(_weights(jax_out))
    return Predictor(model, model.state_dict(), t_spec(graphs, B),
                     device="cpu").screen_library(graphs, slab=36, mesh=mesh)


@pytest.mark.parametrize("world", [1, 2])
def test_screen_library_mesh_matches_single_device(runs, world):
    """(4) screen_library(mesh=) at worlds 1 (this process) and 2 (the
    ranks, both returning every score) against one device: slabs of 36
    and 28 molecules, 5 and 4 blocks."""
    load, jax_out, _ = runs
    want = _screen_single(jax_out)
    if world == 1:
        try:
            got = _screen_single(jax_out, make_mesh(1, device="cpu"))
        finally:
            dist.destroy_process_group()
        np.testing.assert_array_equal(got, want)
        return
    r0, r1 = load("screen")
    assert torch.equal(r0["scores"], r1["scores"])
    np.testing.assert_allclose(r0["scores"].numpy(), want, rtol=1e-6,
                               atol=1e-6)


def test_dp_device_sampling(runs):
    """(5) With device sampling the ranks draw different ids, take
    max(ceil(40/8) // 2, 1) = 2 steps an epoch, and end bit-equal."""
    load, _, _ = runs
    r0, r1 = load("sample")
    assert not torch.equal(r0["first"], r1["first"])
    assert r0["step"] == r1["step"] == 2 * 2
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k


def test_dp_fit_needs_a_batch_per_device(runs):
    """(6) ceil(40/64) = 1 batch for 2 ranks raises on both."""
    load, _, _ = runs
    for r in load("few"):
        assert "id-batch per device" in r["message"]


def test_multihost_helpers_in_a_world_of_two(runs):
    """(7) host_shard and local_device_batches by rank, against the JAX
    package's with the same process ids."""
    from molkgnn_tpu.parallel import multihost as j_multihost

    load, _, _ = runs
    rows = np.arange(6).reshape(2, 3)
    for rank, r in enumerate(load("multihost")):
        assert r["shard"] == j_multihost.host_shard(
            list(range(10)), process_id=rank, process_count=2)
        np.testing.assert_array_equal(r["rows"].numpy(), rows[rank:rank + 1])


@pytest.mark.parametrize("names", ["jax", "launcher"])
def test_initialize_from_environment(names, monkeypatch):
    """(7) initialize() joins from the JAX package's names or a
    launcher's (a world of one here), is idempotent, and the data mesh
    spans the world."""
    port = str(launch.free_port())
    env = ({"COORDINATOR_ADDRESS": f"localhost:{port}",
            "NUM_PROCESSES": "1", "PROCESS_ID": "0"} if names == "jax" else
           {"MASTER_ADDR": "localhost", "MASTER_PORT": port,
            "WORLD_SIZE": "1", "RANK": "0"})
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.env_world() == 1
    try:
        assert multihost.initialize(device="cpu") is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert multihost.initialize(device="cpu") is False
        mesh = multihost.global_data_mesh(device="cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
        assert multihost.host_shard(list(range(5))) == list(range(5))
    finally:
        dist.destroy_process_group()


def test_mesh_refusals():
    """No world of 2 without processes, no NCCL on the CPU, and no mesh
    of another size than the world."""
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        make_mesh(1, device="cpu", backend="nccl")
    try:
        make_mesh(1, device="cpu")
        with pytest.raises(ValueError, match="world of 1"):
            make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()
    assert [list(rank_rows(np.arange(7), 3, r)) for r in range(3)] == [
        [0, 3], [1, 4], [2, 5]]


def test_cli_two_ranks_on_cpu(tmp_path, monkeypatch):
    """(8) --num_devices 2 --device cpu: two ranks over gloo, one set of
    artifacts written by rank 0; --model_parallel hybrid over ranks that
    --num_data_shards does not divide is refused before any rank starts."""
    from molkgnn_torch.cli import entry as t_entry

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    root = tmp_path / "run"
    assert t_entry.main([
        "--device", "cpu", "--num_devices", "2", "--dataset_name",
        "synthetic", "--synthetic_graphs", "48", "--max_epochs", "1",
        "--batch_size", "8", "--num_layers", "1", "--hidden_dim", "8",
        "--default_root_dir", str(root)]) == 0
    info = (root / "logs" / "task_info.log").read_text()
    assert info.count("task_name:") == 1 and "ranks: 2" in info
    assert "[last]" in (root / "logs" / "test_result.log").read_text()
    assert (root / "checkpoints" / "last.pt").exists()
    assert (root / "logs" / "kernels" / "kernels.npz").exists()
    with pytest.raises(SystemExit, match="not divisible"):
        t_entry.main(["--device", "cpu", "--num_devices", "3",
                      "--model_parallel", "hybrid"])


def test_schnet_dp_step_matches_jax(runs):
    """(9) SchNet: one DP step on two ranks against the JAX package's DP
    step, as tests/test_parallel.py runs that family on a mesh."""
    load, jax_out, _ = runs
    r0, r1 = load("schnet")
    loss, variables = jax_out["schnet"]
    for r in (r0, r1):
        np.testing.assert_allclose(float(r["loss"]), loss, rtol=1e-9)
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    _assert_state(r0["state"], variables, **R64)


def test_rank0_writes_and_resume(runs):
    """(10) A stop signal on rank 0 after the second of 3 epochs stops
    both ranks there; rank 0 alone wrote checkpoints, autosaves and logs.
    The run resumed from that autosave on both ranks (each its own
    sampler's state) ends as an uninterrupted 3-epoch run, bit for bit."""
    load, _, out = runs
    r0, r1 = load("resume")
    assert r1["writes"] == []
    for part in ("autosave.state.pt", "ckpt", "autosave.history.json",
                 "logs/history.json"):
        assert any(part in w for w in r0["writes"]), part
    for r in (r0, r1):
        assert len(r["losses"]) == 2  # the resumed third epoch
        assert r["losses"] == r["whole_losses"][-2:]
        for k in r["whole"]:
            assert torch.equal(r["resumed"][k], r["whole"][k]), k
        assert r["stopped_epochs"] == 2
    assert (out / "resumed" / "ckpt" / "last.pt").exists()
