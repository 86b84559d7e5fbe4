"""Port parity: fixed (human-designed) kernel sets and score capture.

The port's ``MolKGNNNet(fixed_kernels=...)`` against the JAX package's on
the same numpy inputs and weights (the weight bridge), in fp64 on tie-free
molecules (no permutation argmax rests on an exact tie): forward and
gradients within rtol 1e-7 / atol 1e-9, the same arithmetic in another
summation order. Also the ``[fixed; trainable]`` block order, the frozen
tensors (no gradient, no optimizer state, not in ``state_dict()``), the
weight bridge and the reference-layout import both ways, the
``customized_kernels/`` files and the layer-0 score capture, and the
scorer's one launch over 8 groups whose degrees share their A.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.analyses import fixed_kernels as t_fixed
from molkgnn_torch.data.dataset import Dataset as TDataset
from molkgnn_torch.data.dataset import QSAR_METRICS
from molkgnn_torch.data.synthetic import tie_free_molgraph
from molkgnn_torch.graphs import batch as t_batch
from molkgnn_torch.models import kgnn as t_kgnn
from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.training.checkpoint import (
    from_jax_variables,
    from_torch_state_dict as t_import,
)
from molkgnn_torch.training.model import GNNModel
from molkgnn_torch.training.optim import make_optimizer
from molkgnn_torch.training.trainer import TrainConfig, Trainer
from molkgnn_tpu.analyses import fixed_kernels as j_fixed
from molkgnn_tpu.graphs import batch as j_batch
from molkgnn_tpu.graphs.molgraph import MolGraph as JMolGraph
from molkgnn_tpu.models import kgnn as j_kgnn
from molkgnn_tpu.training.checkpoint import from_torch_state_dict as j_import
from molkgnn_tpu.training.model import GNNModel as JGNNModel

R64 = dict(rtol=1e-7, atol=1e-9)
CFG = dict(num_layers=2, kernels_1hop=(2, 3, 2, 3), kernels_nhop=(2, 3, 2, 3),
           graph_embedding_dim=8)
FIXED_COUNTS = (2, 3, 2, 4)  # per degree; None where a count is 0


def _fixed(seed=0, counts=FIXED_COUNTS, f=28, e=7):
    rng = np.random.default_rng(seed)
    return tuple(
        None if n == 0 else {
            "x_center": rng.standard_normal((n, f)).astype(np.float32),
            "x_support": rng.standard_normal((n, d, f)).astype(np.float32),
            "edge_attr_support":
                rng.standard_normal((n, d, e)).astype(np.float32),
            "p_support": rng.standard_normal((n, d, 3)).astype(np.float32),
        }
        for d, n in enumerate(counts, 1)
    )


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


def _np_float32_as_float64():
    """A numpy whose float32 is float64, for the JAX kgnn module. That
    package casts a fixed set's tensors to float32 constants
    (``np.asarray(..., np.float32)`` in its KernelConv) even under
    jax_enable_x64, so its kernel-side normalisation of them runs in
    float32; with this stand-in the fp64 comparisons keep the same values
    (the sets are float32 numbers) in float64, as the port's ``.double()``
    keeps them."""
    stand_in = types.SimpleNamespace(
        **{k: getattr(np, k) for k in dir(np) if not k.startswith("__")})
    stand_in.float32 = np.float64
    return stand_in


def _as_double(batch):
    cast = lambda t: t.double() if t.is_floating_point() else t
    return dataclasses.replace(
        batch, x=cast(batch.x), p=cast(batch.p),
        edge_attr=cast(batch.edge_attr), y=cast(batch.y),
        **{f"deg{d}": dataclasses.replace(
            b, nei_edge_attr=cast(b.nei_edge_attr))
           for d, b in enumerate(batch.buckets(), start=1)},
    )


@pytest.fixture(scope="module")
def mols():
    """8 tie-free molecules as port graphs and the same as a JAX batch."""
    rng = np.random.default_rng(31)
    graphs = [tie_free_molgraph(rng) for _ in range(8)]
    jgraphs = [JMolGraph(x=g.x, p=g.p, edge_index=g.edge_index,
                         edge_attr=g.edge_attr, y=g.y,
                         atomic_num=g.atomic_num).with_fields()
               for g in graphs]
    spec = t_batch.spec_for_graphs(graphs, 8)
    jbatch = j_batch.batch_graphs(jgraphs, j_batch.spec_for_graphs(jgraphs, 8))
    return graphs, spec, jbatch


def _models(fixed, use_kernel=False, sow_scores=False, **kw):
    cfg = dict(CFG, **kw)
    jm = JGNNModel(encoder=j_kgnn.MolKGNNNet(
        **cfg, fixed_kernels=fixed, sow_scores=sow_scores),
        ffn_dropout_rate=0.0)
    tm = GNNModel(t_kgnn.MolKGNNNet(
        **cfg, fixed_kernels=fixed, use_kernel=use_kernel,
        sow_scores=sow_scores), ffn_dropout_rate=0.0)
    return jm, tm


def _template(jm, jbatch, seed=0):
    return jax.device_get(jax.jit(jm.init)(jax.random.key(seed), jbatch))


@pytest.fixture(scope="module")
def jax_run(mols):
    """The JAX package's side of the comparisons, once: a fixed-kernel
    template (float32 init) and, in fp64, the forward, the gradients of
    every parameter and layer 0's captured scores from its weights."""
    _, _, jbatch = mols
    fixed = _fixed()
    jm, _ = _models(fixed, sow_scores=True)
    template = _template(jm, jbatch)
    v, jb = _as64(template), _as64(jbatch)

    def loss(params):
        pred, emb = jm.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb)
        return jnp.sum(pred) + jnp.sum(emb ** 2), (pred, emb)

    # The JAX package's capture_layer0_scores over a jitted apply (it
    # calls model.apply(variables, batch, train=False,
    # mutable=["intermediates"]); eager, that apply takes tens of seconds).
    sow = jax.jit(lambda v, b: jm.apply(v, b, train=False,
                                        mutable=["intermediates"]))
    jitted = types.SimpleNamespace(
        apply=lambda v, b, train, mutable: sow(v, b))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_kgnn, "np", _np_float32_as_float64())
        (_, (pred, emb)), grads = _x64(lambda: jax.device_get(
            jax.jit(jax.value_and_grad(loss, has_aux=True))(v["params"])))
        scores = _x64(lambda: j_fixed.capture_layer0_scores(jitted, v, jb))
    return dict(fixed=fixed, jm=jm, template=template, v=v, pred=pred,
                emb=emb, grads=grads, scores=scores)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fixed_kernels_forward_and_grads_match_jax_fp64(mols, jax_run,
                                                         use_kernel):
    """Forward (prediction and embedding) and the gradient of every
    parameter, fixed sets at layer 0 for every degree; the port's scorer
    path (one grouped call of 8 groups, its plain version on the CPU) and
    its product form both."""
    graphs, spec, _ = mols
    _, tm = _models(jax_run["fixed"], use_kernel=use_kernel)
    tm = tm.double().eval()
    tm.load_state_dict(from_jax_variables(jax_run["v"]), strict=True)
    pred, emb = tm(_as_double(t_batch.batch_graphs(graphs, spec)))
    np.testing.assert_allclose(pred.detach().numpy(), jax_run["pred"], **R64)
    np.testing.assert_allclose(emb.detach().numpy(), jax_run["emb"], **R64)
    (pred.sum() + (emb ** 2).sum()).backward()
    want = from_jax_variables({"params": jax_run["grads"]})
    # Parameters the forward never reads (the length/angle weights, the
    # edge BatchNorm in eval mode) have no gradient here, zeros there.
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    assert any("fixed_kernelconv_set" in k for k in got)
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), err_msg=k,
                                   **R64)


def test_block_order_is_fixed_then_trainable(mols):
    """A degree's columns are [fixed; trainable]: with fixed kernels equal
    to the trainable ones in reverse order, each block reads
    [reversed(T); T]; block_widths counts both; layer 1's input widens by
    the fixed columns."""
    graphs, spec, _ = mols
    _, tm = _models(None, sow_scores=True)
    layer0 = tm.gnn_model.gnn.layers[0]
    fixed = tuple(
        {name: getattr(conv, name).detach().numpy()[::-1]
         for name in t_fixed.KERNEL_FIELDS}
        for conv in layer0.trainable_kernelconv_set
    )
    fm = GNNModel(t_kgnn.MolKGNNNet(**CFG, fixed_kernels=fixed,
                                    sow_scores=True), ffn_dropout_rate=0.0)
    fm.gnn_model.gnn.layers[0].trainable_kernelconv_set.load_state_dict(
        layer0.trainable_kernelconv_set.state_dict())
    batch = t_batch.batch_graphs(graphs, spec)
    with torch.no_grad():
        tm.eval()(batch)
        fm.eval()(batch)
    widths = fm.gnn_model.gnn.layers[0].block_widths()
    assert widths == tuple(2 * n for n in CFG["kernels_1hop"])
    assert fm.gnn_model.gnn.layers[1].trainable_kernelconv_set[0].node_dim \
        == sum(widths)
    plain = layer0.scores.numpy()
    got = fm.gnn_model.gnn.layers[0].scores.numpy()
    col = 0
    for d, n in enumerate(CFG["kernels_1hop"]):
        t_block = plain[:, sum(CFG["kernels_1hop"][:d]):][:, :n]
        np.testing.assert_array_equal(got[:, col:col + n], t_block[:, ::-1])
        np.testing.assert_array_equal(got[:, col + n:col + 2 * n], t_block)
        col += 2 * n
    assert np.any(plain != 0)


def test_frozen_tensors_have_no_grad_no_state_and_stay_put(mols, tmp_path):
    """The fixed sets' four tensors are buffers outside ``state_dict()``
    and the optimizer, with no gradient; their score weights are
    parameters. Three Trainer steps leave the tensors bit-equal and move
    the score weights."""
    graphs, spec, _ = mols
    _, tm = _models(_fixed())
    fixed_set = tm.gnn_model.gnn.layers[0].fixed_kernelconv_set
    assert sorted(fixed_set) == ["0", "1", "2", "3"]
    params = dict(tm.named_parameters())
    for d, conv in fixed_set.items():
        for name in t_fixed.KERNEL_FIELDS:
            t = getattr(conv, name)
            assert not t.requires_grad
            assert f"gnn_model.gnn.layers.0.fixed_kernelconv_set.{d}.{name}" \
                not in tm.state_dict()
        assert f"gnn_model.gnn.layers.0.fixed_kernelconv_set.{d}." \
            "support_attr_sc_weight" in params
    opt = make_optimizer(tm, weight_decay=0.0)
    assert len(opt.params) == len(params)
    start = {(d, n): getattr(c, n).clone() for d, c in fixed_set.items()
             for n in t_fixed.KERNEL_FIELDS}
    weights = {d: c.support_attr_sc_weight.detach().clone()
               for d, c in fixed_set.items()}
    for i, g in enumerate(graphs):
        g.y, g.idx = float(i % 2), i
    ds = TDataset("tie_free", graphs, {"train": np.arange(8),
                                       "valid": np.arange(8),
                                       "test": np.arange(8)},
                  list(QSAR_METRICS), "bce_with_logits")
    trainer = Trainer(tm, ds, spec, TrainConfig(
        batch_size=8, warmup_iterations=1, progress=False,
        log_dir=str(tmp_path)), device="cpu")
    for _ in range(3):
        trainer._step_ids(np.arange(8, dtype=np.int32))
    for (d, n), t in start.items():
        assert torch.equal(getattr(fixed_set[d], n), t), (d, n)
    for d, w in weights.items():
        assert not torch.equal(fixed_set[d].support_attr_sc_weight, w), d


def test_state_dict_loads_into_a_jax_fixed_template(jax_run):
    """The port's state_dict of a fixed-kernel model goes through the JAX
    importer into a template built with the same fixed sets (no missing,
    extra or misshapen key) and back, unchanged."""
    fixed, template = jax_run["fixed"], jax_run["template"]
    gen = torch.Generator().manual_seed(3)
    port = GNNModel(t_kgnn.MolKGNNNet(**CFG, fixed_kernels=fixed,
                                      generator=gen), generator=gen)
    sd = port.state_dict()
    back = from_jax_variables(j_import(template, sd))
    assert set(back) == set(sd)
    for k, t in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), t.numpy(), err_msg=k)


def test_reference_layout_import_and_refusals(mols, jax_run):
    """A reference checkpoint's fixed-set score weights import into both
    packages' fixed-kernel models alike; its fixed kernel tensors have no
    target in either (constants of the model) and both refuse them as
    leftovers; a model without fixed sets refuses the checkpoint."""
    _, _, jbatch = mols
    fixed, template = jax_run["fixed"], jax_run["template"]
    _, tm = _models(fixed)
    ref = {k: v.numpy() + 0.5 for k, v in from_jax_variables(
        template).items()}
    ref["lin1.weight"] = np.zeros((2, 2), np.float32)  # a dead key
    tm.load_state_dict(t_import(tm, ref), strict=True)
    want = from_jax_variables(j_import(template, ref))
    for k, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), want[k].numpy(), err_msg=k)
        np.testing.assert_array_equal(t.numpy(), ref[k], err_msg=k)

    with_tensors = dict(ref)
    with_tensors["gnn_model.gnn.layers.0.fixed_kernelconv_set.0.x_center"] \
        = fixed[0]["x_center"]
    with pytest.raises(ValueError, match="no target"):
        t_import(tm, with_tensors)
    with pytest.raises(ValueError, match="no target"):
        j_import(template, with_tensors)

    # Without fixed sets the layers after layer 0 are narrower, so both
    # refuse at a shape before they reach the leftover keys.
    jplain, tplain = _models(None)
    with pytest.raises(ValueError, match="shape mismatch"):
        t_import(tplain, ref)
    with pytest.raises(ValueError, match="shape mismatch"):
        j_import(_template(jplain, jbatch), ref)


def test_capture_layer0_scores_matches_jax(mols, jax_run):
    """Layer 0's node-order scores through the port's capture_layer0_scores
    against the JAX package's, fp64, from the same weights; the port
    restores the model's mode and capture flag."""
    graphs, spec, _ = mols
    _, tm = _models(jax_run["fixed"])
    tm = tm.double().train()
    tm.load_state_dict(from_jax_variables(jax_run["v"]), strict=True)
    got = t_fixed.capture_layer0_scores(
        tm, _as_double(t_batch.batch_graphs(graphs, spec)))
    np.testing.assert_allclose(got, jax_run["scores"], **R64)
    layer0 = tm.gnn_model.gnn.layers[0]
    assert tm.training and not layer0.sow_scores and layer0.scores is None
    assert got.shape[1] == sum(layer0.block_widths())


def test_customized_kernel_files_and_score_dump_match_jax(tmp_path):
    """Files written by the port read back equal through both loaders
    (names, absent degrees); score_headers and dump_scores write the same
    scores.csv as the JAX package's."""
    fixed = _fixed(counts=(2, 0, 3, 1))
    names = (["a", "b"], [], ["c", "d", "e"], [])
    t_fixed.save_customized_kernels(str(tmp_path / "ck"), fixed, names)
    for loader in (t_fixed.load_customized_kernels,
                   j_fixed.load_customized_kernels):
        kernels, got_names = loader(str(tmp_path / "ck"))
        assert kernels[1] is None and got_names[1] == []
        assert got_names[0] == ["a", "b"] and got_names[3] == [
            "fixed_kernel_0"]
        for want, got in zip(fixed, kernels):
            if want is not None:
                for k in t_fixed.KERNEL_FIELDS:
                    np.testing.assert_array_equal(got[k], want[k])
    trainable = (2, 3, 2, 3)
    _, loaded_names = t_fixed.load_customized_kernels(str(tmp_path / "ck"))
    assert t_fixed.score_headers(loaded_names, trainable) == \
        j_fixed.score_headers(loaded_names, trainable)
    width = 6 + sum(trainable)
    scores = np.random.default_rng(0).standard_normal((5, width))
    t_fixed.dump_scores(scores, loaded_names, trainable,
                        str(tmp_path / "t.csv"))
    j_fixed.dump_scores(scores, loaded_names, trainable,
                        str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    with pytest.raises(ValueError, match="kernel columns"):
        t_fixed.dump_scores(scores[:, 1:], loaded_names, trainable,
                            str(tmp_path / "bad.csv"))


def test_eight_groups_with_shared_a_backward():
    """The grouped scorer over 8 groups, two per degree sharing one A
    tensor, one B frozen in each pair: outputs equal the plain version,
    A's gradient is the sum of both groups' contributions (autograd through
    the plain einsum + max as the reference), no gradient for a frozen
    B."""
    gen = torch.Generator().manual_seed(8)
    a_list, b_list, shapes = [], [], []
    for d, (lf, lt) in zip(range(1, 5), [(2, 3), (3, 2), (2, 4), (4, 3)]):
        k, p = d * 6, (1, 2, 6, 12)[d - 1]
        a = torch.randn(7 + d, k, generator=gen, dtype=torch.float64,
                        requires_grad=True)
        for l, frozen in ((lf, True), (lt, False)):
            b = torch.randn(p, k, l, generator=gen, dtype=torch.float64)
            a_list.append(a)
            b_list.append(b if frozen else b.requires_grad_())
    outs = ss.grouped_support_score(a_list, b_list)
    g = [torch.randn(best.shape, generator=gen, dtype=torch.float64)
         for best, _ in outs]
    sum((best * w).sum() for (best, _), w in zip(outs, g)).backward()
    got_a = [a_list[i].grad.clone() for i in range(0, 8, 2)]
    got_b = [b.grad for b in b_list]
    for t in a_list + b_list:
        t.grad = None
    plain = [torch.einsum("mk,pkl->mlp", a, b).max(dim=2)
             for a, b in zip(a_list, b_list)]
    for (best, idx), (want_best, want_idx) in zip(outs, plain):
        torch.testing.assert_close(best, want_best)
        assert torch.equal(idx.long(), want_idx)
    sum((p.values * w).sum() for p, w in zip(plain, g)).backward()
    for i, got in zip(range(0, 8, 2), got_a):
        torch.testing.assert_close(got, a_list[i].grad, rtol=1e-12,
                                   atol=1e-12)
    for i, (got, b) in enumerate(zip(got_b, b_list)):
        if i % 2 == 0:
            assert got is None and not b.requires_grad
        else:
            torch.testing.assert_close(got, b.grad, rtol=1e-12, atol=1e-12)


def test_kernelconv_init_kernel_trainable_and_shape_check():
    """Given kernels with trainable_kernels=True are parameters holding the
    given values (in ``state_dict()``); a wrong shape raises, as in the JAX
    package."""
    fixed = _fixed(counts=(0, 3, 0, 0))[1]
    conv = t_kgnn.KernelConv(deg=2, num_kernels=3, node_dim=28, edge_dim=7,
                             init_kernel=fixed)
    for name in t_fixed.KERNEL_FIELDS:
        assert getattr(conv, name).requires_grad
        np.testing.assert_array_equal(conv.state_dict()[name].numpy(),
                                      fixed[name])
    bad = dict(fixed, p_support=fixed["p_support"][:, :1])
    with pytest.raises(ValueError, match="p_support"):
        t_kgnn.KernelConv(deg=2, num_kernels=3, node_dim=28, edge_dim=7,
                          init_kernel=bad, trainable_kernels=False)
