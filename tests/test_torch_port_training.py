"""Port parity: the training path against the JAX package.

Both packages train the same molecules with the same weights (carried over
by ``from_jax_variables``) and the same sampled ids. Tolerances:

  * the scorer's hand-written backward against ``jax.vjp`` of the Pallas
    scorer (interpret mode), fp32 on random inputs (no near ties): 1e-5,
    as ``tests/test_pallas.py``;
  * losses (fp32): 1e-6; schedule: 1e-6 relative (JAX evaluates it in
    fp32); clipping (fp32): 1e-6; metrics: 1e-12 (the same float64
    arithmetic as scikit-learn);
  * train step, three steps, the skipped step and fit/test: fp64 on
    tie-free molecules, dropout 0, a 2-layer narrow model, weight decay
    0.1, clipping at 2.0 (it triggers on steps 1 and 3, not 2). Gradients
    1e-9. Losses, parameters and metrics 1e-7 relative: optax computes
    Adam's bias corrections in fp32 from its int32 count, which moves each
    update by ~1e-8 of itself.
"""

import contextlib
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molkgnn_torch.data.dataset import QSAR_METRICS
from molkgnn_torch.data.dataset import Dataset as TDataset
from molkgnn_torch.data.synthetic import random_dataset, tie_free_molgraph
from molkgnn_torch.graphs.batch import spec_for_graphs as t_spec
from molkgnn_torch.graphs.device_pack import gather_batch as t_gather
from molkgnn_torch.models.kgnn import MolKGNNNet as TNet
from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.training import metrics as t_metrics
from molkgnn_torch.training import optim as t_optim
from molkgnn_torch.training.checkpoint import from_jax_variables
from molkgnn_torch.training.model import LOSSES as T_LOSSES
from molkgnn_torch.training.model import GNNModel as TModel
from molkgnn_torch.training.schedule import polynomial_warmup_decay as t_sched
from molkgnn_torch.training.trainer import TRACE_KEYS
from molkgnn_torch.training.trainer import TrainConfig as TConfig
from molkgnn_torch.training.trainer import Trainer as TTrainer
from molkgnn_tpu.data.dataset import Dataset as JDataset
from molkgnn_tpu.graphs import spec_for_graphs as j_spec
from molkgnn_tpu.graphs.device_pack import gather_batch as j_gather
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models import MolKGNNNet as JNet
from molkgnn_tpu.ops.pallas_kernels import grouped_support_score as j_grouped
from molkgnn_tpu.training import GNNModel as JModel
from molkgnn_tpu.training import TrainConfig as JConfig
from molkgnn_tpu.training import Trainer as JTrainer
from molkgnn_tpu.training import metrics as j_metrics
from molkgnn_tpu.training.model import LOSSES as J_LOSSES
from molkgnn_tpu.training.optim import decay_mask
from molkgnn_tpu.training.schedule import polynomial_warmup_decay as j_sched

CFG = dict(
    num_layers=2, kernels_1hop=(2, 3, 2, 3), kernels_nhop=(2, 3, 2, 3),
    graph_embedding_dim=8,
)
KW = dict(
    batch_size=8, max_epochs=3, warmup_iterations=3, weight_decay=0.1,
    grad_clip_norm=2.0, skip_nonfinite_updates=True, train_metric=True,
    record_valid_pred=True, progress=False,
)
R64 = dict(rtol=1e-7, atol=1e-9)


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree.map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree,
    )


def _variables(state):
    return jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}
    )


def _copy(state):
    """A copy the donating train step may consume."""
    return jax.tree.map(lambda a: a.copy(), state)


@pytest.fixture(scope="module")
def data():
    """40 tie-free molecules with 0/1 labels, split 24/8/8, as a port and
    a JAX dataset sharing graphs' arrays and split."""
    rng = np.random.default_rng(5)
    graphs = [tie_free_molgraph(rng) for _ in range(40)]
    jgraphs = []
    for i, g in enumerate(graphs):
        g.y, g.idx = float(rng.random() < 0.4), i
        jg = JMolGraph(
            x=g.x, p=g.p, edge_index=g.edge_index, edge_attr=g.edge_attr,
            y=g.y, atomic_num=g.atomic_num,
        ).with_fields()
        jg.idx = i
        jgraphs.append(jg)
    perm = rng.permutation(40)
    split = {"train": np.sort(perm[:24]), "valid": np.sort(perm[24:32]),
             "test": np.sort(perm[32:])}
    for part in ("valid", "test"):
        assert len({graphs[i].y for i in split[part]}) == 2
    return (
        TDataset("tie_free", graphs, split, list(QSAR_METRICS),
                 "bce_with_logits"),
        JDataset("tie_free", jgraphs, split, list(QSAR_METRICS),
                 "bce_with_logits"),
        t_spec(graphs, 8),
        j_spec(jgraphs, 8),
    )


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """Everything the JAX Trainer computes for the comparisons, in fp64 on
    one trainer: the first step's gradients, three steps, a skipped step
    then a clean one, and fit + test from the same initial state."""
    _, jds, _, jspec = data
    out_dir = tmp_path_factory.mktemp("jax_run")
    with _x64():
        jt = JTrainer(
            JModel(encoder=JNet(**CFG), ffn_dropout_rate=0.0), jds, jspec,
            JConfig(**KW, log_dir=str(out_dir / "logs")),
        )
        params = _f64(jt.state.params)
        jt.state = jt.state.replace(
            params=params, batch_stats=_f64(jt.state.batch_stats),
            opt_state=jt.tx.init(params),
        )
        jt._device_data = _f64(jt._device_data)
        state0 = jt.state
        rng = np.random.default_rng(0)
        ids = [rng.choice(jds.split["train"], 8, replace=False)
               .astype(np.int32) for _ in range(3)]
        ids[2][6:] = -1  # a padded batch

        batch = j_gather(jt._device_data, jnp.asarray(ids[0]), jspec)

        def loss(p):
            (pred, _), _ = jt.model.apply(
                {"params": p, "batch_stats": state0.batch_stats}, batch,
                train=True, mutable=["batch_stats"],
            )
            return jt.loss_fn(pred, batch.y, batch.graph_mask)

        grads = jax.device_get(jax.jit(jax.grad(loss))(state0.params))

        steps, st = [], _copy(state0)
        for idv in ids:
            st, value = jt._train_step_ids(st, jt._device_data, idv)
            steps.append((float(value), _variables(st)))

        poisoned = dataclasses.replace(
            jt._device_data, x=jnp.full_like(jt._device_data.x, jnp.nan)
        )
        st, skipped_loss = jt._train_step_ids(_copy(state0), poisoned, ids[0])
        skipped = (float(skipped_loss), int(st.step), _variables(st))
        st, clean_loss = jt._train_step_ids(st, jt._device_data, ids[0])
        clean = (float(clean_loss), int(st.step), _variables(st))

        jt.state = _copy(state0)
        history = jt.fit()
        tested = jt.test()
    return dict(
        v0=jax.device_get(
            {"params": state0.params, "batch_stats": state0.batch_stats}
        ),
        ids=ids, grads=grads, steps=steps, skipped=skipped, clean=clean,
        history=history, test=tested, final=_variables(jt.state),
        tags=set(jt._ckpts), log_dir=out_dir / "logs",
    )


def _port(data, jax_run, use_kernel=False, tmp_path=None, **kw):
    """The port's Trainer in fp64 on the CPU from the JAX run's weights."""
    tds, _, tspec, _ = data
    model = TModel(TNet(**CFG, use_kernel=use_kernel), ffn_dropout_rate=0.0)
    model = model.double()
    model.load_state_dict(from_jax_variables(jax_run["v0"]), strict=True)
    cfg = dict(KW, **kw)
    if tmp_path is not None:
        cfg.update(log_dir=str(tmp_path / "logs"),
                   checkpoint_dir=str(tmp_path / "ckpt"))
    tt = TTrainer(model, tds, tspec, TConfig(**cfg), device="cpu")
    if tt._device_data is not None:
        dd = tt._device_data
        tt._device_data = dataclasses.replace(
            dd, x=dd.x.double(), p=dd.p.double(),
            edge_attr=dd.edge_attr.double(), y=dd.y.double(),
            deg_ea=tuple(a.double() for a in dd.deg_ea),
        )
    return tt


def _assert_state_matches(tt, variables, **tol):
    want = from_jax_variables(variables)
    got = tt.model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k].numpy(), w.numpy(), err_msg=k, **tol
        )


# --------------------------------------------------------- the scorer's VJP
VJP_CASES = {
    "grouped_ragged": [
        (37, 28, 10, 1), (61, 56, 20, 2), (23, 84, 30, 6), (49, 112, 50, 12),
    ],
    **{f"one_group_p{p}": [(29, 3 * p + 5, 7, p)] for p in (1, 2, 6, 12)},
}


@pytest.mark.parametrize("case", sorted(VJP_CASES))
def test_scorer_backward_matches_jax_vjp(case):
    """The Function's backward (gradient through the chosen permutation
    only) against the JAX scorer's custom VJP, interpret mode, fp32."""
    rng = np.random.default_rng(len(case))
    shapes = VJP_CASES[case]
    a = [rng.standard_normal((m, k)).astype(np.float32)
         for m, k, _, _ in shapes]
    b = [rng.standard_normal((p, k, l)).astype(np.float32)
         for _, k, l, p in shapes]
    g = [rng.standard_normal((m, l)).astype(np.float32)
         for m, _, l, _ in shapes]

    def loss_jax(a_t, b_t):
        outs = j_grouped(list(a_t), list(b_t), interpret=True)
        return sum(jnp.sum(best * gi) for (best, _), gi in zip(outs, g))

    want = jax.grad(loss_jax, argnums=(0, 1))(
        tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b))
    )
    ta = [torch.from_numpy(x).requires_grad_() for x in a]
    tb = [torch.from_numpy(x).requires_grad_() for x in b]
    if len(shapes) == 1:
        outs = [ss.fused_support_score(ta[0], tb[0])]
    else:
        outs = ss.grouped_support_score(ta, tb)
    assert all(best.grad_fn is not None for best, _ in outs)
    assert all(not idx.requires_grad for _, idx in outs)
    sum((best * torch.from_numpy(gi)).sum()
        for (best, _), gi in zip(outs, g)).backward()
    for got, w in zip([t.grad for t in ta + tb], [*want[0], *want[1]]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_scorer_without_autograd_skips_the_function():
    """Under no_grad (evaluation, serving) the wrappers return the forward
    directly: no graph is recorded."""
    a = torch.randn(5, 6, requires_grad=True)
    b = torch.randn(2, 6, 3, requires_grad=True)
    with torch.no_grad():
        best, _ = ss.fused_support_score(a, b)
    assert best.grad_fn is None and not best.requires_grad


# ------------------------------------------------- losses, schedule, optim
@pytest.mark.parametrize("name", sorted(T_LOSSES))
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(32) * 4).astype(np.float32)
    x[3] = 0.0  # the stable form's kink
    y = (rng.random(32) < 0.5).astype(np.float32)
    m = rng.random(32) < 0.7
    want = J_LOSSES[name](jnp.asarray(x), jnp.asarray(y), jnp.asarray(m))
    got = T_LOSSES[name](*map(torch.from_numpy, (x, y, m)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_schedule_matches_jax():
    """Steps 1, warmup, warmup + 1, tot and tot + 5: the schedule takes
    the 0-based count of updates already applied."""
    peak, end, warm, tot = 5e-3, 1e-10, 10, 100
    js, ts = j_sched(peak, end, warm, tot), t_sched(peak, end, warm, tot)
    for step in (1, warm, warm + 1, tot, tot + 5):
        np.testing.assert_allclose(
            ts(step - 1), float(js(step - 1)), rtol=1e-6
        )
    assert ts(0) == peak / warm and ts(tot - 1) == end


def test_tensor_schedule_equals_float_schedule():
    """The schedule on a count tensor (what a captured step reads) equals
    the float schedule bit for bit at every count, through warmup, decay
    and past the end."""
    from molkgnn_torch.training.schedule import (
        polynomial_warmup_decay_tensor,
    )

    for args in ((5e-3, 1e-10, 10, 100), (5e-2, 1e-9, 60002, 6360 * 20 + 2),
                 (1e-2, 0.0, 0, 7)):
        ts = t_sched(*args)
        tt = polynomial_warmup_decay_tensor(*args)
        counts = sorted({0, 1, args[2] - 1, args[2], args[2] + 1,
                         args[3] - 2, args[3] - 1, args[3], args[3] + 5,
                         *range(0, args[3] + 3, max(args[3] // 37, 1))})
        for c in counts:
            got = tt(torch.tensor(c, dtype=torch.int64))
            assert got.dtype == torch.float64
            assert float(got) == ts(c), (args, c)


def test_adamw_apply_flag_selects_the_update():
    """AdamW.step with apply=True equals apply=None bit for bit; with
    apply=False parameters, moments and the count stay as they were."""
    def fresh():
        torch.manual_seed(0)
        model = TModel(TNet(**CFG))
        opt = t_optim.make_optimizer(model, weight_decay=0.1)
        for p in opt.params:
            p.grad = torch.randn_like(p)
        return model, opt

    lr = torch.tensor(1e-2, dtype=torch.float64)
    runs = {}
    for flag in (None, True, False):
        model, opt = fresh()
        before = [p.detach().clone() for p in opt.params]
        apply = None if flag is None else torch.tensor(flag)
        for _ in range(2):
            opt.step(lr, apply)
        runs[flag] = (model, opt, before)
    m_none, o_none, _ = runs[None]
    m_true, o_true, _ = runs[True]
    for a, b in zip(o_none.params, o_true.params):
        assert torch.equal(a, b)
    assert int(o_none.count) == int(o_true.count) == 2
    _, o_false, before = runs[False]
    for p, b in zip(o_false.params, before):
        assert torch.equal(p, b)
    assert int(o_false.count) == 0
    assert all(not m.any() for m in o_false.exp_avg + o_false.exp_avg_sq)


def test_decay_partition_matches_jax(jax_run):
    """The port decays exactly the parameters the JAX mask decays;
    edge_attr_support_sc_weight decays, the kernel tensors do not."""
    mask = decay_mask(jax_run["v0"]["params"])
    want = {k for k, v in from_jax_variables({"params": mask}).items()
            if bool(v)}
    decay, no_decay = t_optim.decay_partition(TModel(TNet(**CFG)))
    assert set(decay) == want
    assert any(n.endswith("edge_attr_support_sc_weight") for n in decay)
    assert all(n.rsplit(".", 1)[1] in t_optim.NO_DECAY_NAMES
               for n in no_decay)


@pytest.mark.parametrize("max_norm", [100.0, 1.5])
def test_clip_matches_optax(max_norm):
    """Below the norm the gradients pass unchanged; above it they become
    g / norm * max_norm, optax's formula."""
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState()
    )
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    t_optim.clip_by_global_norm(params, max_norm)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_sklearn_metrics(seed):
    """The numpy metrics against the JAX package's, which call
    scikit-learn, on scores with many ties."""
    rng = np.random.default_rng(seed)
    n = 300
    y = (rng.random(n) < 0.2).astype(np.float32)
    s = np.round(rng.standard_normal(n), 1).astype(np.float32)
    names = list(QSAR_METRICS) + ["accuracy", "RMSE"]
    want = j_metrics.compute_metrics(names, y, s)
    got = t_metrics.compute_metrics(names, y, s)
    for k in names:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    fpr, tpr, thr = t_metrics.roc_curve(y, s)
    from sklearn.metrics import roc_curve

    for a, b in zip((fpr, tpr, thr), roc_curve(y, s)):
        np.testing.assert_array_equal(a, b)


def test_auc_falls_back_to_minus_one():
    """Where roc_auc_score refuses the input the reference reports -1."""
    assert t_metrics.calculate_auc(np.zeros(5), np.arange(5.0)) == -1.0
    assert t_metrics.calculate_auc(
        np.array([0, 1, 0]), np.array([0.1, np.nan, 0.3])
    ) == -1.0


# ------------------------------------------------------- the train step
@pytest.mark.parametrize("use_kernel", [False, True])
def test_train_step_gradients_match_jax(data, jax_run, use_kernel):
    """One step's gradients, every parameter, both scorer paths; the
    parameters that never reach the loss get zeros, as from jax.grad."""
    tt = _port(data, jax_run, use_kernel=use_kernel)
    batch = t_gather(tt._device_data, torch.as_tensor(jax_run["ids"][0]),
                     tt.spec)
    tt._loss(batch).backward()
    unused = [n for n, p in tt.model.named_parameters() if p.grad is None]
    assert any(n.endswith("length_sc_weight") for n in unused)
    t_optim.fill_missing_grads(tt._params)
    want = from_jax_variables({"params": jax_run["grads"]})
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_three_steps_match_jax(data, jax_run, use_kernel):
    """Losses, weights and BatchNorm statistics after each of three AdamW
    steps (weight decay, clipping, a padded batch)."""
    tt = _port(data, jax_run, use_kernel=use_kernel)
    for idv, (want_loss, want_vars) in zip(jax_run["ids"], jax_run["steps"]):
        loss = float(tt._step_ids(idv))
        np.testing.assert_allclose(loss, want_loss, rtol=1e-7)
        _assert_state_matches(tt, want_vars, **R64)
    assert tt.step == tt.updates == 3


def test_skip_nonfinite_matches_jax(data, jax_run):
    """A step with NaN gradients applies no update and leaves Adam's and
    the schedule's counts where they were (the next clean step is a first
    update); only the step counter advances. BatchNorm statistics take the
    NaN batch's values, as in the JAX package."""
    tt = _port(data, jax_run)
    before = {k: v.clone() for k, v in tt.model.named_parameters()}
    clean = tt._device_data
    tt._device_data = dataclasses.replace(
        clean, x=torch.full_like(clean.x, float("nan"))
    )
    skipped_loss, skipped_step, skipped_vars = jax_run["skipped"]
    loss = float(tt._step_ids(jax_run["ids"][0]))
    assert np.isnan(loss) and np.isnan(skipped_loss)
    assert (tt.step, tt.updates) == (skipped_step, 0) == (1, 0)
    for k, p in tt.model.named_parameters():
        assert torch.equal(p, before[k]), k
    _assert_state_matches(tt, skipped_vars, **R64)

    tt._device_data = clean
    clean_loss, clean_step, clean_vars = jax_run["clean"]
    np.testing.assert_allclose(
        float(tt._step_ids(jax_run["ids"][0])), clean_loss, rtol=1e-7
    )
    assert (tt.step, tt.updates) == (clean_step, 1)
    _assert_state_matches(tt, clean_vars, **R64)


# ------------------------------------------------------------ the Trainer
@pytest.mark.parametrize("use_kernel", [False, True])
def test_fit_and_test_match_jax(data, jax_run, tmp_path, use_kernel):
    """fit + test against the JAX Trainer with the same seed: the same
    sampled ids, so the same per-epoch train loss, validation metrics (and
    the train split's, _no_dropout), final weights, test metrics per
    checkpoint, and artifact files."""
    tt = _port(data, jax_run, use_kernel=use_kernel, tmp_path=tmp_path)
    history = tt.fit()
    tested = tt.test()
    assert len(history) == len(jax_run["history"]) == KW["max_epochs"]
    for got, want in zip(history, jax_run["history"]):
        assert set(got) == set(want) | set(TRACE_KEYS)
        for k, w in want.items():
            if k not in TRACE_KEYS:
                np.testing.assert_allclose(got[k], w, err_msg=k, **R64)
    _assert_state_matches(tt, jax_run["final"], **R64)
    assert tested.keys() == jax_run["test"].keys()
    for tag, metrics in jax_run["test"].items():
        for k, w in metrics.items():
            np.testing.assert_allclose(tested[tag][k], w, err_msg=k, **R64)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(tmp_path / "logs") == files(jax_run["log_dir"])
    assert set(tt._ckpts) == jax_run["tags"]
    assert files(tmp_path / "ckpt") == sorted(
        f"{t}.pt" for t in jax_run["tags"]
    )
    with open(tmp_path / "logs" / "history.json") as f:
        assert [e["epoch"] for e in json.load(f)] == [0, 1, 2]


# --------------------------------------------------- the port's own runs
def _small_trainer(tmp_path, sub, drop=0.3, seed=7, **kw):
    graphs = random_dataset(seed=3, num_graphs=32, active_fraction=0.3)
    perm = np.random.default_rng(4).permutation(32)
    ds = TDataset(
        "synthetic", graphs,
        {"train": np.sort(perm[:20]), "valid": np.sort(perm[20:26]),
         "test": np.sort(perm[26:])},
        list(QSAR_METRICS), "bce_with_logits",
    )
    gen = torch.Generator().manual_seed(1)
    model = TModel(TNet(num_layers=1, kernels_1hop=(2, 2, 2, 2),
                        kernels_nhop=(2, 2, 2, 2), graph_embedding_dim=8,
                        drop_ratio=drop, use_kernel=True, generator=gen),
                   ffn_dropout_rate=drop, generator=gen)
    cfg = dict(batch_size=8, max_epochs=4, warmup_iterations=3, seed=seed,
               progress=False, tot_iterations=14,
               log_dir=str(tmp_path / sub / "logs"))
    cfg.update(kw)
    return TTrainer(model, ds, t_spec(graphs, 8), TConfig(**cfg),
                    device="cpu")


def _params(tt):
    return {k: v.clone() for k, v in tt.model.state_dict().items()}


def test_dropout_runs_repeat_exactly(tmp_path):
    """Dropout draws from the Trainer's generator, seeded from the config:
    two runs with the same seed are identical, another seed differs."""
    a, b = _small_trainer(tmp_path, "a"), _small_trainer(tmp_path, "b")
    c = _small_trainer(tmp_path, "c", seed=8)
    for t in (a, b, c):
        t.fit()
    assert a.step_losses == b.step_losses != c.step_losses
    for k, v in _params(a).items():
        assert torch.equal(v, _params(b)[k]), k


def test_host_loader_path_equals_device_path(tmp_path):
    """use_device_data=False packs the same sampled batches on the host:
    the same run, bit for bit."""
    dev = _small_trainer(tmp_path, "dev")
    host = _small_trainer(tmp_path, "host", use_device_data=False)
    assert host._device_data is None
    assert dev.fit() and host.fit()
    assert dev.step_losses == host.step_losses
    for a, b in zip(dev.history, host.history):
        assert {k: v for k, v in a.items() if not k.endswith("time_s")} == {
            k: v for k, v in b.items() if not k.endswith("time_s")
        }
    assert dev.test() == host.test()


def test_resume_equals_uninterrupted(tmp_path):
    """A run stopped after 2 of 4 epochs and resumed from its autosave (a
    fresh Trainer: weights, optimizer, both random streams, counters)
    ends where the uninterrupted run ends, bit for bit."""
    straight = _small_trainer(tmp_path, "straight")
    straight.fit()
    auto = str(tmp_path / "auto")
    first = _small_trainer(tmp_path, "first", max_epochs=2,
                           autosave_path=auto)
    first.fit()
    assert os.path.exists(auto + ".state.pt")
    second = _small_trainer(tmp_path, "second", autosave_path=auto)
    history = second.fit()
    assert [e["epoch"] for e in history] == [0, 1, 2, 3]
    assert second.step == straight.step == 12
    assert second.step_losses == straight.step_losses[6:]
    for k, v in _params(straight).items():
        assert torch.equal(v, _params(second)[k]), k


def test_sigterm_finishes_epoch_autosaves_and_resumes(tmp_path):
    class _StopAfterFirstEpoch:
        def on_epoch_end(self, epoch, results):
            if epoch == 0:
                os.kill(os.getpid(), signal.SIGTERM)

    auto = str(tmp_path / "auto")
    t1 = _small_trainer(tmp_path, "t1", autosave_path=auto)
    t1.monitor = _StopAfterFirstEpoch()
    assert len(t1.fit()) == 1
    t2 = _small_trainer(tmp_path, "t2", autosave_path=auto)
    assert [e["epoch"] for e in t2.fit()] == [0, 1, 2, 3]


def test_save_kernels_and_graph_embedding(tmp_path):
    tt = _small_trainer(tmp_path, "k", max_epochs=1)
    tt.fit()
    tt.save_kernels(str(tmp_path / "out"))
    tt.save_graph_embedding(str(tmp_path / "out"))
    kernels = np.load(tmp_path / "out" / "kernels.npz")
    assert "kernelconv4/x_support" in kernels.files
    emb = np.load(tmp_path / "out" / "graph_embedding.npy")
    assert emb.shape == (6, 8) and np.isfinite(emb).all()


def test_trainer_needs_cuda_unless_cpu_is_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt = _small_trainer(tmp_path, "cpu")
    assert tt.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTrainer(tt.model, tt.dataset, tt.spec, tt.config)
