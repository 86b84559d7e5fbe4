"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

They skip where no card is present. This file imports neither JAX nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.ops.similarity import normalize_rows

# Cases of (M, K, L, P) groups, each scored in one grouped launch. The
# kernel's block tiles are 200 rows x 10 kernels at P = 12 (and any P > 6),
# 136 x 30 at P = 6 (and P = 3..5), 408 x 20 at P = 2 and 512 x 10 at P = 1.
CASES = {
    # The ragged shapes of tests/test_pallas.py's grouped case, plus P > 12
    # (passes of 12 permutations) and L past several column tiles.
    "ragged": [
        (37, 28, 10, 1), (61, 56, 20, 2), (23, 84, 30, 6), (49, 112, 50, 12),
        (1, 3, 70, 13), (130, 500, 129, 25),
    ],
    "rows_at_tile_edges": [
        (0, 28, 10, 1), (1, 56, 20, 2), (199, 44, 50, 12), (200, 44, 50, 12),
        (201, 44, 50, 12), (135, 33, 30, 6), (136, 33, 30, 6),
        (137, 33, 30, 6), (407, 17, 20, 2), (408, 17, 20, 2),
        (409, 17, 20, 2), (511, 9, 10, 1), (512, 9, 10, 1), (513, 9, 10, 1),
    ],
    "k_mod_4": [(50, k, 50, 12) for k in (1, 2, 3, 5, 6, 7, 110, 330)],
    "ragged_kernels": [(70, 19, l, 6) for l in (3, 10, 50, 65, 129)],
    "permutations": [(45, 21, 11, p) for p in (1, 2, 3, 5, 6, 12, 13, 25)],
    "sixteen_groups": [(9 + i, 5 + i, 3 + i, 1 + i % 13) for i in range(16)],
    # The flagship N-hop layer at batch 1024: degrees 1-4.
    "flagship_nhop": [
        (19232, 110, 10, 1), (13640, 220, 20, 2), (8144, 330, 30, 6),
        (7064, 440, 50, 12),
    ],
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


def _unit_operands(rng, shapes):
    """Operands that are unit vectors along k, as on the model's path: the
    scores are cosines, so the 1e-5 tolerance is against values of order 1.
    """
    a = [
        normalize_rows(torch.from_numpy(rng.standard_normal((m, k)))).float()
        for m, k, _, _ in shapes
    ]
    b = [
        normalize_rows(torch.from_numpy(rng.standard_normal((p, l, k))))
        .float().transpose(1, 2).contiguous()
        for _, k, l, p in shapes
    ]
    return [x.cuda() for x in a], [x.cuda() for x in b]


def _assert_matches_plain(outs, a_list, b_list):
    """best within 1e-5 of the plain version; argmax equal wherever the
    top two scores are more than 1e-4 apart."""
    for (best, idx), a, b in zip(outs, a_list, b_list):
        want_best, want_idx = ss.support_score_plain(a, b)
        assert best.shape == want_best.shape and idx.dtype == torch.int32
        torch.testing.assert_close(best, want_best, rtol=1e-5, atol=1e-5)
        if a.shape[0] == 0:
            continue
        sc = torch.einsum("mk,pkl->mlp", a.double(), b.double())
        top2 = sc.topk(min(2, sc.shape[2]), dim=2).values
        clear = (top2[..., 0] - top2[..., -1] > 1e-4) | (sc.shape[2] == 1)
        assert torch.equal(idx[clear], want_idx[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain(case):
    """The kernel against its plain version in one grouped launch."""
    _needs_card()
    a_list, b_list = _unit_operands(np.random.default_rng(1), CASES[case])
    before = ss.grouped_support_score.launches
    outs = ss.grouped_support_score(a_list, b_list)
    torch.cuda.synchronize()
    assert ss.grouped_support_score.launches == before + 1
    _assert_matches_plain(outs, a_list, b_list)


@pytest.mark.cuda
def test_cuda_kernel_takes_views_with_an_offset():
    """Contiguous views that start inside their storage (4-byte aligned
    only) are accepted and scored right."""
    _needs_card()
    (a,), (b,) = _unit_operands(np.random.default_rng(2), [(77, 110, 30, 6)])
    a_buf = torch.zeros(a.numel() + 1, device="cuda")
    a_buf[1:] = a.flatten()
    b_buf = torch.zeros(b.numel() + 3, device="cuda")
    b_buf[3:] = b.flatten()
    a_view, b_view = a_buf[1:].view(a.shape), b_buf[3:].view(b.shape)
    assert a_view.storage_offset() == 1 and a_view.is_contiguous()
    outs = [ss.fused_support_score(a_view, b_view)]
    torch.cuda.synchronize()
    _assert_matches_plain(outs, [a], [b])


@pytest.mark.cuda
def test_cuda_tie_break_first():
    _needs_card()
    a = torch.ones(4, 8, device="cuda")
    b = torch.ones(5, 8, 3, device="cuda")
    assert torch.all(ss.fused_support_score(a, b)[1] == 0)
    for _, idx in ss.grouped_support_score([a, a], [b, b]):
        assert torch.all(idx == 0)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take():
    _needs_card()
    a = torch.ones(4, 8, device="cuda")
    b = torch.ones(2, 8, 3, device="cuda")
    with pytest.raises(TypeError):
        ss.fused_support_score(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        ss.fused_support_score(a, b.transpose(1, 2).contiguous().mT)
    with pytest.raises(ValueError, match="groups"):
        ss.grouped_support_score([a] * 17, [b] * 17)


@pytest.mark.cuda
def test_cuda_predictor_kernel_path_matches_plain_form():
    """Predictor on the card: one grouped launch per layer and chunk, and
    the same scores as the plain-product form (fp32, one layer)."""
    _needs_card()
    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.serving.predictor import Predictor
    from molkgnn_torch.training.model import GNNModel

    graphs = random_dataset(seed=9, num_graphs=40)
    spec = spec_for_graphs(graphs, 16)

    def model(use_kernel):
        gen = torch.Generator().manual_seed(2)
        return GNNModel(
            MolKGNNNet(num_layers=1, use_kernel=use_kernel, generator=gen),
            generator=gen,
        )

    m = model(True)
    sd = m.state_dict()
    before = ss.grouped_support_score.launches
    got = Predictor(m, sd, spec).predict_graphs(graphs)
    assert ss.grouped_support_score.launches == before + 3  # 3 chunks
    want = Predictor(model(False), sd, spec).predict_graphs(graphs)
    assert got.shape == (40,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _plain_grads(a_list, b_list, g_list):
    """Gradients of sum(best * g) by autograd through einsum, then max."""
    a_list = [a.detach().requires_grad_() for a in a_list]
    b_list = [b.detach().requires_grad_() for b in b_list]
    loss = sum(
        (torch.einsum("mk,pkl->mlp", a, b).max(dim=2).values * g).sum()
        for a, b, g in zip(a_list, b_list, g_list)
    )
    loss.backward()
    return [t.grad for t in a_list + b_list]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "permutations", "flagship_nhop"])
def test_cuda_scorer_gradients_match_plain(case):
    """The Function on the card (kernel forward, kernel backward) against
    autograd through the plain version: max |diff| <= 1e-4. The
    upstream gradient is zero where the top two scores are within 1e-4, so
    that no entry rests on an argmax the two may break differently."""
    _needs_card()
    a_list, b_list = _unit_operands(np.random.default_rng(3), CASES[case])
    gen = torch.Generator(device="cuda").manual_seed(0)
    g_list = []
    for a, b in zip(a_list, b_list):
        sc = torch.einsum("mk,pkl->mlp", a.double(), b.double())
        top2 = sc.topk(min(2, sc.shape[2]), dim=2).values
        clear = (top2[..., 0] - top2[..., -1] > 1e-4) | (sc.shape[2] == 1)
        g = torch.randn(sc.shape[:2], generator=gen, device="cuda")
        g_list.append(torch.where(clear, g, 0.0))
    ta = [a.clone().requires_grad_() for a in a_list]
    tb = [b.clone().requires_grad_() for b in b_list]
    before = ss.grouped_support_score.launches
    outs = ss.grouped_support_score(ta, tb)
    assert ss.grouped_support_score.launches == before + 1
    before = ss.support_score_backward.launches
    sum((best * g).sum() for (best, _), g in zip(outs, g_list)).backward()
    assert ss.support_score_backward.launches == before + 1
    want = _plain_grads(a_list, b_list, g_list)
    for got, w in zip([t.grad for t in ta + tb], want):
        assert (got - w).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_cuda_gather_batch_matches_cpu():
    """The batch assembled on the card equals the one assembled on the CPU
    (and so the host packer's), bit for bit, with -1 padded ids."""
    _needs_card()
    import dataclasses

    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.graphs.device_pack import (
        DeviceDataset,
        gather_batch,
        pad_ids,
    )
    from molkgnn_torch.graphs.packed import PackedGraphs

    graphs = random_dataset(seed=4, num_graphs=64)
    spec = spec_for_graphs(graphs, 16)
    packed = PackedGraphs.from_graphs(graphs)
    ids = torch.from_numpy(pad_ids(np.arange(3, 40, 3), 16))
    want = gather_batch(DeviceDataset.from_packed(packed), ids, spec)
    got = gather_batch(
        DeviceDataset.from_packed(packed, "cuda"), ids.cuda(), spec
    ).to("cpu")
    for bucket_g, bucket_w in zip(got.buckets(), want.buckets()):
        for f in dataclasses.fields(bucket_w):
            assert torch.equal(getattr(bucket_g, f.name),
                               getattr(bucket_w, f.name))
    for f in dataclasses.fields(want):
        if not f.name.startswith("deg"):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name))


@pytest.mark.cuda
def test_cuda_trainer_step():
    """One Trainer step on the card (its default device): one grouped
    launch per layer, a finite loss, and a support-score gradient for
    x_support."""
    _needs_card()
    from molkgnn_torch.data.dataset import make_synthetic_dataset
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.training.model import GNNModel
    from molkgnn_torch.training.trainer import TrainConfig, Trainer

    ds = make_synthetic_dataset(seed=1, num_graphs=64)
    gen = torch.Generator().manual_seed(0)
    model = GNNModel(
        MolKGNNNet(num_layers=2, use_kernel=True, generator=gen),
        generator=gen,
    )
    trainer = Trainer(model, ds, spec_for_graphs(ds.graphs, 16),
                      TrainConfig(batch_size=16, progress=False))
    assert trainer.device.type == "cuda"
    ids = next(trainer._epoch_id_batches())
    before = ss.grouped_support_score.launches
    loss = trainer._step_ids(ids)
    assert ss.grouped_support_score.launches == before + 2
    assert torch.isfinite(loss).item()
    conv = model.gnn_model.gnn.layers[0].trainable_kernelconv_set[3]
    assert conv.x_support.grad.abs().sum().item() > 0


def _small_run(tmp_path, sub, dropout=0.25, **kw):
    """A 2-layer model with the scorer kernel and dropout 0.25 (or
    ``dropout``) on 320 tie-free molecules (256 train: 8 steps of 32 an
    epoch), on the card; with balanced_batches, under the dealt tight
    spec."""
    from molkgnn_torch.data.dataset import make_tie_free_dataset
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.training.model import GNNModel
    from molkgnn_torch.training.trainer import TrainConfig, Trainer

    ds = make_tie_free_dataset(320, 256, seed=3, active_fraction=0.3)
    gen = torch.Generator().manual_seed(5)
    model = GNNModel(
        MolKGNNNet(num_layers=2, use_kernel=True, drop_ratio=dropout,
                   generator=gen),
        ffn_dropout_rate=dropout, generator=gen,
    )
    cfg = dict(batch_size=32, max_epochs=1, warmup_iterations=4,
               tot_iterations=40, progress=False,
               log_dir=str(tmp_path / sub / "logs"))
    mesh = kw.pop("mesh", None)
    cfg.update(kw)
    if cfg.get("balanced_batches"):
        from molkgnn_torch.graphs.balance import spec_for_dataset

        spec = spec_for_dataset(ds, 32)
    else:
        spec = spec_for_graphs(ds.graphs, 32)
    return Trainer(model, ds, spec, TrainConfig(**cfg), mesh=mesh)


def _max_param_diff(a, b):
    sb = b.model.state_dict()
    return max((v - sb[k]).abs().max().item()
               for k, v in a.model.state_dict().items())


@pytest.mark.cuda
@pytest.mark.parametrize("device_sampling", [False, True])
def test_cuda_graphed_steps_equal_eager_steps(tmp_path, device_sampling):
    """8 steps with dropout on, eager (scan_steps=1) and through the
    captured graph (scan_steps=8: 2 eager warm-up steps, then replays):
    the same ids and dropout masks, so losses within 1e-5 relative and
    parameters within 1e-5 (index_add_ sums in its own order on each run).
    An unregistered dropout generator would replay one mask and fail."""
    _needs_card()
    runs = {}
    for k in (1, 8):
        t = _small_run(tmp_path, f"k{k}", scan_steps=k,
                       device_sampling=device_sampling)
        before = ss.grouped_support_score.launches
        t.fit()
        runs[k] = (t, ss.grouped_support_score.launches - before)
    eager, graphed = runs[1][0], runs[8][0]
    assert eager.step == graphed.step == 8
    assert graphed._graph is not None
    losses = np.array(graphed.step_losses)
    np.testing.assert_allclose(losses, eager.step_losses, rtol=1e-5)
    assert len(set(losses.tolist())) == 8  # every step drew its own batch
    assert _max_param_diff(eager, graphed) <= 1e-5
    # The scorer's launches: 2 a step (one a layer), replays included, and
    # 2 for the one validation batch; the capture itself launches none.
    assert runs[1][1] == runs[8][1] == 2 * 8 + 2


@pytest.mark.cuda
def test_cuda_sample_ids_follow_the_weights():
    _needs_card()
    from molkgnn_torch.data.dataset import oversampling_weights
    from molkgnn_torch.graphs.device_pack import alias_sampler, sample_ids

    rng = np.random.default_rng(4)
    labels = (rng.random(300) < 0.05).astype(np.float32)
    labels[:3] = 1.0
    weights = oversampling_weights(labels)
    table = alias_sampler(weights)
    prob = torch.from_numpy(table.prob).cuda()
    alias = torch.from_numpy(table.alias).cuda()
    ids = torch.arange(300, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    draws = torch.cat([sample_ids(gen, prob, alias, ids, 1000)
                       for _ in range(200)]).cpu().numpy()
    counts = np.bincount(draws, minlength=300)
    p = weights / weights.sum()
    expected = p * draws.size
    sigma = np.sqrt(draws.size * p * (1 - p))
    assert np.all(np.abs(counts - expected) <= 5 * sigma)


@pytest.mark.cuda
def test_cuda_resumed_graphed_run_equals_uninterrupted(tmp_path):
    """Device sampling with scan_steps=4: a run stopped after 2 of 4 epochs
    and resumed from its autosave in a fresh Trainer (which captures its
    own graph) ends within 1e-5 of the uninterrupted run."""
    _needs_card()
    kw = dict(scan_steps=4, device_sampling=True, max_epochs=4)
    straight = _small_run(tmp_path, "straight", **kw)
    straight.fit()
    auto = str(tmp_path / "auto")
    _small_run(tmp_path, "first", **dict(kw, max_epochs=2),
               autosave_path=auto).fit()
    second = _small_run(tmp_path, "second", autosave_path=auto, **kw)
    second.fit()
    assert second.step == straight.step == 32
    np.testing.assert_allclose(second.step_losses, straight.step_losses[16:],
                               rtol=1e-5)
    assert _max_param_diff(straight, second) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "flagship_nhop"])
def test_cuda_op_matches_plain(case):
    """The registered op's CUDA implementation, grouped (all groups in one
    launch) and fused (one group), against its plain version: the flat
    outputs hold each group's best and idx back to back, and the launch is
    counted on the wrapper that ``fused`` names."""
    _needs_card()
    a_list, b_list = _unit_operands(np.random.default_rng(6), CASES[case])
    for fused, groups in ((False, [list(range(len(a_list)))]),
                          (True, [[i] for i in range(len(a_list))])):
        for group in groups:
            a = [a_list[i] for i in group]
            b = [b_list[i] for i in group]
            before = ss.launch_counts()
            best, idx = torch.ops.molkgnn.support_score(a, b, fused)
            torch.cuda.synchronize()
            after = ss.launch_counts()
            assert after[0] - before[0] == int(fused)  # fused_support_score
            assert after[1] - before[1] == int(not fused)
            outs, o = [], 0
            for x, y in zip(a, b):
                m, l = x.shape[0], y.shape[2]
                outs.append((best[o:o + m * l].view(m, l),
                             idx[o:o + m * l].view(m, l)))
                o += m * l
            assert best.numel() == idx.numel() == o
            _assert_matches_plain(outs, a, b)


def _tie_free_model(num_layers=2, seed=4):
    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.training.model import GNNModel

    gen = torch.Generator().manual_seed(seed)
    return GNNModel(MolKGNNNet(num_layers=num_layers, use_kernel=True,
                               generator=gen), generator=gen)


def _tie_free_graphs(n, seed=8):
    from molkgnn_torch.data.synthetic import tie_free_molgraph

    rng = np.random.default_rng(seed)
    return [tie_free_molgraph(rng) for _ in range(n)]


@pytest.mark.cuda
def test_cuda_captured_evaluation_equals_eager():
    """The block scorer on the card (first block eager, then one captured
    forward replayed per block) against eager forwards, within 1e-5 on
    tie-free molecules; 2 scorer launches a block (2 layers), replays
    counted, on the capturing call and on a call that only replays."""
    _needs_card()
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.graphs.device_pack import (
        DeviceDataset,
        gather_batch,
        pad_ids,
    )
    from molkgnn_torch.graphs.packed import PackedGraphs
    from molkgnn_torch.serving.blocks import BlockScorer

    graphs = _tie_free_graphs(150)
    spec = spec_for_graphs(graphs, 32)
    data = DeviceDataset.from_packed(PackedGraphs.from_graphs(graphs), "cuda")
    ids = np.arange(150, dtype=np.int32)
    idm = torch.as_tensor(np.stack(
        [pad_ids(ids[s:s + 32], 32) for s in range(0, 150, 32)]),
        device="cuda")
    model = _tie_free_model().cuda().eval()
    with torch.no_grad():
        want = torch.stack([model(gather_batch(data, row, spec))[0]
                            for row in idm])
    scorer = BlockScorer(model, spec)
    for _ in range(2):
        before = ss.grouped_support_score.launches
        got = scorer(data, idm)
        torch.cuda.synchronize()
        assert ss.grouped_support_score.launches - before == 2 * 5
        assert scorer._graph is not None
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_screen_library_across_two_slabs_matches_predict_graphs():
    _needs_card()
    from molkgnn_torch.graphs.batch import spec_for_graphs
    from molkgnn_torch.serving.predictor import Predictor

    graphs = _tie_free_graphs(300, seed=9)
    spec = spec_for_graphs(graphs, 32)
    model = _tie_free_model()
    pred = Predictor(model, model.state_dict(), spec)
    want = pred.predict_graphs(graphs)
    before = ss.grouped_support_score.launches
    got = pred.screen_library(graphs, slab=160)
    assert [s["molecules"] for s in pred.screen_slabs] == [160, 140]
    # 5 + 5 blocks of 32, 2 launches each.
    assert ss.grouped_support_score.launches - before == 2 * 10
    assert got.shape == (300,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_exported_program_runs_the_kernel(tmp_path):
    """Exported on the card and loaded without the model: the program's
    scorer nodes launch the kernel (counted) and it scores as the
    Predictor does."""
    _needs_card()
    from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
    from molkgnn_torch.serving.predictor import Predictor

    graphs = _tie_free_graphs(64, seed=10)
    spec = spec_for_graphs(graphs, 32)
    model = _tie_free_model()
    pred = Predictor(model, model.state_dict(), spec)
    path = str(tmp_path / "model.pt2")
    program = pred.export(path)
    targets = [str(n.target) for n in program.graph.nodes]
    assert sum("molkgnn.support_score" in t for t in targets) == 2
    call, got_spec = Predictor.load_exported(path)
    assert got_spec == spec
    before = ss.grouped_support_score.launches
    out, emb = call(batch_graphs(graphs[:32], spec))
    torch.cuda.synchronize()
    assert ss.grouped_support_score.launches - before == 2
    assert out.device.type == "cuda" and emb.shape == (32, 32)
    np.testing.assert_allclose(out.cpu().numpy(),
                               pred.predict_graphs(graphs[:32]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_train_capture_unchanged_by_an_evaluation_capture(tmp_path):
    """2 epochs of 8 steps with scan_steps=4, so that the evaluation graph
    is captured between the train step's replays (validation after epoch
    0), against eager steps: losses within 1e-5 relative, parameters
    within 1e-5; the scorer's launches as counted for eager steps."""
    _needs_card()
    runs = {}
    for k in (1, 4):
        t = _small_run(tmp_path, f"k{k}", scan_steps=k, max_epochs=2)
        before = ss.grouped_support_score.launches
        t.fit()
        runs[k] = (t, ss.grouped_support_score.launches - before)
    eager, graphed = runs[1][0], runs[4][0]
    assert graphed._graph is not None and graphed._blocks._graph is not None
    np.testing.assert_allclose(graphed.step_losses, eager.step_losses,
                               rtol=1e-5)
    assert _max_param_diff(eager, graphed) <= 1e-5
    assert runs[1][1] == runs[4][1] == 2 * 16 + 2 * 2


# ------------------------------------------------------ the point families
POINT_SMALL = {
    "schnet": dict(num_layers=2, hidden_channels=16, num_filters=16,
                   num_gaussians=10, out_channels=8),
    "dimenet_pp": dict(num_blocks=2, hidden_channels=16, out_channels=8,
                       int_emb_size=8, basis_emb_size=4, out_emb_channels=16,
                       num_spherical=3, num_radial=4),
    "spherenet": dict(num_layers=2, hidden_channels=16, out_channels=8,
                      int_emb_size=8, basis_emb_size_dist=4,
                      basis_emb_size_angle=4, basis_emb_size_torsion=4,
                      out_emb_channels=16, num_spherical=3, num_radial=4),
}
POINT_CUTOFF = 3.5


def _point_setup(name, n=24, batch=8, seed=12):
    """(molecules of at most 12 atoms, the family's spec at ``batch``, a
    small GNNModel of the family with weights from a seed)."""
    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_torch.models.registry import get_family
    from molkgnn_torch.training.model import GNNModel

    graphs = random_dataset(seed=seed, num_graphs=n)
    for g in graphs:
        k = min(g.num_nodes, 12)
        g.p, g.atomic_num, g.x = g.p[:k], g.atomic_num[:k], g.x[:k]
    family = get_family(name)
    spec = family.make_spec(graphs, batch, cutoff=POINT_CUTOFF)
    gen = torch.Generator().manual_seed(seed)
    model = GNNModel(family.make_encoder(cutoff=POINT_CUTOFF, generator=gen,
                                         **POINT_SMALL[name]),
                     ffn_dropout_rate=0.0, generator=gen)
    return graphs, spec, model


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(POINT_SMALL))
def test_cuda_gather_points_matches_batch_points(name):
    """The on-card point gather equals the host packer bit for bit."""
    _needs_card()
    from molkgnn_torch.graphs.device_pack import pad_ids
    from molkgnn_torch.graphs.device_points import (
        DevicePointDataset,
        gather_points,
    )
    from molkgnn_torch.graphs.geometric import batch_points

    graphs, spec, _ = _point_setup(name)
    data = DevicePointDataset.from_graphs(graphs, spec, "cuda")
    for ids in ([0, 1, 2, 3, 4, 5, 6, 7], [20, 3, 9], []):
        idv = torch.as_tensor(pad_ids(np.asarray(ids, np.int32), 8),
                              device="cuda")
        got = gather_points(data, idv, spec)
        want = batch_points([graphs[i] for i in ids], spec)
        for a, b in zip(got.leaves(), want.leaves()):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(POINT_SMALL))
def test_cuda_point_forward_fp64_matches_cpu(name):
    """The family's forward in float64 on the card against the CPU, same
    weights and batch: within 1e-9."""
    _needs_card()
    import dataclasses

    from molkgnn_torch.graphs.geometric import batch_points

    graphs, spec, model = _point_setup(name)
    batch = batch_points(graphs[:8], spec)
    batch = dataclasses.replace(batch, pos=batch.pos.double(),
                                y=batch.y.double())
    model = model.double().eval()
    with torch.no_grad():
        want = model(batch)
        got = model.cuda()(batch.to("cuda"))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(POINT_SMALL))
def test_cuda_point_graphed_steps_equal_eager(tmp_path, name):
    """2 epochs with device sampling, eager against scan_steps=4 (a
    captured step replayed): the first 3 losses within 1e-5 relative (the
    atomics' last bits grow with the steps), all finite; no scorer
    launch."""
    _needs_card()
    from molkgnn_torch.data.dataset import QSAR_METRICS, Dataset, _split
    from molkgnn_torch.training.trainer import TrainConfig, Trainer

    graphs, spec, model = _point_setup(name, n=80, batch=8)
    dataset = Dataset("points", graphs, _split(np.random.default_rng(0), 80),
                      list(QSAR_METRICS), "bce_with_logits")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    before = (ss.grouped_support_score.launches,
              ss.fused_support_score.launches)
    for k in (1, 4):
        model.load_state_dict(sd)
        trainer = Trainer(model, dataset, spec, TrainConfig(
            batch_size=8, max_epochs=2, scan_steps=k, oversample=True,
            device_sampling=True, warmup_iterations=4, progress=False,
            log_dir=str(tmp_path / str(k))))
        trainer.fit()
        runs[k] = trainer.step_losses
    assert len(runs[1]) == len(runs[4]) == 16
    assert np.isfinite(runs[1]).all() and np.isfinite(runs[4]).all()
    np.testing.assert_allclose(runs[4][:3], runs[1][:3], rtol=1e-5)
    assert (ss.grouped_support_score.launches,
            ss.fused_support_score.launches) == before


@pytest.mark.cuda
def test_cuda_point_screen_and_export():
    """SphereNet on the card: screen_library (captured blocks) equals
    predict_graphs, and the exported program loads and scores the same."""
    _needs_card()
    import tempfile

    from molkgnn_torch.graphs.geometric import PointBatchSpec, batch_points
    from molkgnn_torch.serving.predictor import Predictor

    graphs, spec, model = _point_setup("spherenet", n=40)
    pred = Predictor(model, model.state_dict(), spec)
    want = pred.predict_graphs(graphs)
    got = pred.screen_library(graphs, slab=24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/spherenet.pt2"
        pred.export(path)
        call, got_spec = Predictor.load_exported(path)
    assert isinstance(got_spec, PointBatchSpec) and got_spec == spec
    out, _ = call(batch_points(graphs[:8], spec))
    np.testing.assert_allclose(out.cpu().numpy(), want[:8], rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------- ChIRoNet
CHIRO_SMILES = ["CCO", "CC(=O)O", "c1ccccc1O", "CCN(C)C", "CC(N)C(=O)O",
                "CCCC", "CC(F)Cl", "CC(N)F"]
CHIRO_SMALL = dict(f_z=(4, 3, 5), f_h=8, f_h_econv=6, econv_mlp_hidden=(5,),
                   gat_hidden=(7,), gat_heads=2, hidden_d=(6,),
                   hidden_phi=(6,), hidden_c=(6,), hidden_shift=(10, 6),
                   hidden_alpha=(6,), cmp_econv_hidden=(9,),
                   cmp_gat_layers=2, cmp_gat_heads=2)


def _chiro_setup(n=24, batch=8, seed=12, **model_kw):
    """(ChiroGraphs of the SMILES above, embedded from seeds, labels
    alternating; the spec at ``batch``; a small ChIRoNet GNNModel with
    weights from a seed)."""
    from molkgnn_torch.chem.embed import embed_molecule
    from molkgnn_torch.chem.smiles import parse_smiles
    from molkgnn_torch.graphs.chiro import (
        chiro_spec_for_graphs,
        mol_to_chiro_graph,
    )
    from molkgnn_torch.models.chironet import ChIRoNet
    from molkgnn_torch.training.model import GNNModel

    graphs = []
    for k in range(n):
        mol = parse_smiles(CHIRO_SMILES[k % len(CHIRO_SMILES)], add_hs=True)
        pos = embed_molecule(mol, seed=seed + k, iterations=40)
        for a, p in zip(mol.atoms, pos):
            a.x, a.y, a.z = map(float, p)
        graphs.append(mol_to_chiro_graph(mol, y=float(k % 2), idx=k))
    spec = chiro_spec_for_graphs(graphs, batch)
    gen = torch.Generator().manual_seed(seed)
    model = GNNModel(ChIRoNet(generator=gen, **CHIRO_SMALL, **model_kw),
                     ffn_dropout_rate=0.0, generator=gen)
    return graphs, spec, model


@pytest.mark.cuda
def test_cuda_gather_chiro_matches_batch_chiro():
    """The on-card ChIRoNet gather equals the host packer bit for bit."""
    _needs_card()
    from molkgnn_torch.graphs.chiro import batch_chiro
    from molkgnn_torch.graphs.device_chiro import (
        DeviceChiroDataset,
        gather_chiro,
    )
    from molkgnn_torch.graphs.device_pack import pad_ids

    graphs, spec, _ = _chiro_setup()
    data = DeviceChiroDataset.from_graphs(graphs, "cuda")
    for ids in ([0, 1, 2, 3, 4, 5, 6, 7], [20, 3, 9], []):
        idv = torch.as_tensor(pad_ids(np.asarray(ids, np.int32), 8),
                              device="cuda")
        got = gather_chiro(data, idv, spec)
        want = batch_chiro([graphs[i] for i in ids], spec)
        for a, b in zip(got.leaves(), want.leaves()):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("options", [
    {}, dict(chiral_message_passing=True, c_normalization="softmax",
             output_mode="both", reduction="mean"),
])
def test_cuda_chiro_forward_fp64_matches_cpu(options):
    """ChIRoNet's forward in float64 on the card against the CPU, same
    weights and batch: within 1e-9 relative to the largest value."""
    _needs_card()
    import dataclasses

    from molkgnn_torch.graphs.chiro import batch_chiro

    graphs, spec, model = _chiro_setup(**options)
    batch = batch_chiro(graphs[:6], spec)
    batch = dataclasses.replace(batch, **{
        f: getattr(batch, f).double()
        for f in ("x", "edge_attr", "distances", "angles", "dihedrals",
                  "y")})
    model = model.double().eval()
    with torch.no_grad():
        want = model(batch)
        got = model.cuda()(batch.to("cuda"))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9 * scale)


@pytest.mark.cuda
def test_cuda_chiro_graphed_steps_equal_eager(tmp_path):
    """2 epochs with device sampling, eager against scan_steps=4 (a
    captured step replayed): the first 3 losses within 1e-5 relative, all
    finite; no scorer launch."""
    _needs_card()
    from molkgnn_torch.data.dataset import QSAR_METRICS, Dataset, _split
    from molkgnn_torch.training.trainer import TrainConfig, Trainer

    graphs, spec, model = _chiro_setup(n=80, batch=8)
    dataset = Dataset("chiro", graphs, _split(np.random.default_rng(0), 80),
                      list(QSAR_METRICS), "bce_with_logits")
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    runs = {}
    before = (ss.grouped_support_score.launches,
              ss.fused_support_score.launches)
    for k in (1, 4):
        model.load_state_dict(sd)
        trainer = Trainer(model, dataset, spec, TrainConfig(
            batch_size=8, max_epochs=2, scan_steps=k, oversample=True,
            device_sampling=True, warmup_iterations=4, progress=False,
            log_dir=str(tmp_path / str(k))))
        trainer.fit()
        runs[k] = trainer.step_losses
    assert len(runs[1]) == len(runs[4]) == 16
    assert np.isfinite(runs[1]).all() and np.isfinite(runs[4]).all()
    np.testing.assert_allclose(runs[4][:3], runs[1][:3], rtol=1e-5)
    assert (ss.grouped_support_score.launches,
            ss.fused_support_score.launches) == before


@pytest.mark.cuda
def test_cuda_chiro_screen_and_export():
    """ChIRoNet on the card: screen_library (captured blocks) equals
    predict_graphs, and the exported program loads and scores the same."""
    _needs_card()
    import tempfile

    from molkgnn_torch.graphs.chiro import ChiroBatchSpec, batch_chiro
    from molkgnn_torch.serving.predictor import Predictor

    graphs, spec, model = _chiro_setup(n=40, chiral_message_passing=True)
    pred = Predictor(model, model.state_dict(), spec)
    want = pred.predict_graphs(graphs)
    got = pred.screen_library(graphs, slab=24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/chironet.pt2"
        pred.export(path)
        call, got_spec = Predictor.load_exported(path)
    assert isinstance(got_spec, ChiroBatchSpec) and got_spec == spec
    out, _ = call(batch_chiro(graphs[:8], spec))
    np.testing.assert_allclose(out.cpu().numpy(), want[:8], rtol=1e-5,
                               atol=1e-5)


def _fixed_sets(counts=(4, 6, 8, 10), f=28, e=7, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        {"x_center": rng.standard_normal((n, f)),
         "x_support": rng.standard_normal((n, d, f)),
         "edge_attr_support": rng.standard_normal((n, d, e)),
         "p_support": rng.standard_normal((n, d, 3))}
        for d, n in enumerate(counts, 1))


@pytest.mark.cuda
def test_cuda_eight_group_launch_matches_plain():
    """One launch over the 8 groups of a fixed-kernel layer 0 at the
    flagship's batch-1024 rows: each degree's fixed and trainable sets
    share one A tensor; outputs against the plain version; gradients
    against autograd through it, A's the sum of both groups', none for the
    frozen B."""
    _needs_card()
    rng = np.random.default_rng(8)
    rows = (19232, 13640, 8144, 7064)
    a_list, b_list = [], []
    for d, (m, lf, lt) in enumerate(zip(rows, (4, 6, 8, 10),
                                        (10, 20, 30, 50)), 1):
        p = (1, 2, 6, 12)[d - 1]
        (a,), (bf,) = _unit_operands(rng, [(m, d * 28, lf, p)])
        (_,), (bt,) = _unit_operands(rng, [(1, d * 28, lt, p)])
        a_list += [a.requires_grad_(), a]
        b_list += [bf, bt.requires_grad_()]
    before = ss.grouped_support_score.launches
    outs = ss.grouped_support_score(a_list, b_list)
    torch.cuda.synchronize()
    assert ss.grouped_support_score.launches == before + 1
    _assert_matches_plain([(b.detach(), i) for b, i in outs],
                          [a.detach() for a in a_list], b_list)
    # Zero upstream gradient within 1e-4 of a tie, as in
    # test_cuda_scorer_gradients_match_plain.
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = []
    for a, b in zip(a_list, b_list):
        sc = torch.einsum("mk,pkl->mlp", a.detach().double(), b.double())
        top2 = sc.topk(min(2, sc.shape[2]), dim=2).values
        clear = (top2[..., 0] - top2[..., -1] > 1e-4) | (sc.shape[2] == 1)
        g.append(torch.where(clear, torch.randn(
            sc.shape[:2], generator=gen, device="cuda"), 0.0))
    shared = [a_list[i] for i in range(0, 8, 2)]
    trained = [b_list[i] for i in range(1, 8, 2)]
    got = torch.autograd.grad(
        sum((best * w).sum() for (best, _), w in zip(outs, g)),
        shared + trained)
    pa = [a.detach().clone().requires_grad_() for a in shared]
    pb = [b.detach().clone().requires_grad_() for b in b_list]
    sum((torch.einsum("mk,pkl->mlp", pa[i // 2], pb[i]).max(dim=2).values
         * g[i]).sum() for i in range(8)).backward()
    want = [x.grad for x in pa] + [pb[i].grad for i in range(1, 8, 2)]
    for x, y in zip(got, want):
        assert (x - y).abs().max().item() <= 1e-4
    assert all(not b.requires_grad for b in b_list[::2])


@pytest.mark.cuda
def test_cuda_fixed_kernel_model_matches_cpu():
    """A 2-layer model with fixed sets for every degree: the kernel path on
    the card against the plain path on the CPU, same weights, tie-free
    molecules; layer 0's captured scores too; 2 launches a forward."""
    _needs_card()
    from molkgnn_torch.analyses.fixed_kernels import capture_layer0_scores
    from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.training.model import GNNModel

    graphs = _tie_free_graphs(32)
    spec = spec_for_graphs(graphs, 32)
    batch = batch_graphs(graphs, spec)
    gen = torch.Generator().manual_seed(2)
    model = GNNModel(MolKGNNNet(num_layers=2, use_kernel=True,
                                fixed_kernels=_fixed_sets(), generator=gen),
                     generator=gen).eval()
    with torch.no_grad():
        want = model(batch)
    want_scores = capture_layer0_scores(model, batch)
    model.cuda()
    before = ss.grouped_support_score.launches
    with torch.no_grad():
        got = model(batch.to("cuda"))
    torch.cuda.synchronize()
    assert ss.grouped_support_score.launches == before + 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
    got_scores = capture_layer0_scores(model, batch.to("cuda"))
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_balanced_graphed_steps_equal_eager(tmp_path):
    """Balanced batches under the dealt tight spec, eager against the
    captured step (scan_steps=8): the same dealt ids, so losses within
    1e-5 relative and parameters within 1e-5; 2 launches a step and a
    validation batch; balanced evaluation equals the cover spec's."""
    _needs_card()
    runs = {}
    for k in (1, 8):
        t = _small_run(tmp_path, f"k{k}", scan_steps=k,
                       balanced_batches=True)
        before = ss.grouped_support_score.launches
        t.fit()
        runs[k] = (t, ss.grouped_support_score.launches - before)
    eager, graphed = runs[1][0], runs[8][0]
    assert graphed._graph is not None and eager.step == graphed.step == 8
    np.testing.assert_allclose(graphed.step_losses, eager.step_losses,
                               rtol=1e-5)
    assert _max_param_diff(eager, graphed) <= 1e-5
    assert runs[1][1] == runs[8][1] == 2 * 8 + 2
    cover = _small_run(tmp_path, "cover")
    cover.model.load_state_dict(graphed.model.state_dict())
    ids = graphed.dataset.split["valid"]
    np.testing.assert_allclose(graphed._predict_ids(ids)[1],
                               cover._predict_ids(ids)[1], rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ data parallel
@pytest.mark.cuda
def test_cuda_dp_world_one_replayed_fit_equals_single_device(tmp_path):
    """A world-1 NCCL mesh with scan_steps=8 (the all-reduce inside the
    captured step) against the single-device Trainer: the same ids, so
    losses within 1e-5 relative, parameters within 1e-5, the same scorer
    launches; then DP evaluation against one device within 1e-5."""
    _needs_card()
    import torch.distributed as dist

    from molkgnn_torch.parallel.data_parallel import make_mesh

    mesh = make_mesh(1)
    try:
        assert dist.get_backend() == "nccl"
        runs = {}
        for name, m in (("single", None), ("dp", mesh)):
            t = _small_run(tmp_path, name, scan_steps=8, mesh=m)
            before = ss.grouped_support_score.launches
            t.fit()
            runs[name] = (t, ss.grouped_support_score.launches - before)
        single, dp = runs["single"][0], runs["dp"][0]
        assert dp._graph is not None and dp.step == single.step == 8
        np.testing.assert_allclose(dp.step_losses, single.step_losses,
                                   rtol=1e-5)
        assert _max_param_diff(single, dp) <= 1e-5
        assert runs["dp"][1] == runs["single"][1] == 2 * 8 + 2
        dp.model.load_state_dict(single.model.state_dict())
        ids = single.dataset.split["valid"]
        np.testing.assert_allclose(dp._predict_ids(ids)[1],
                                   single._predict_ids(ids)[1],
                                   rtol=1e-5, atol=1e-5)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_num_devices_beyond_the_cards_is_refused():
    """--num_devices above the machine's cards raises, naming both."""
    _needs_card()
    from molkgnn_torch.cli import entry

    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=(
            f"{n} ranks need {n} CUDA devices.*has {n - 1}")):
        entry.main(["--num_devices", str(n), "--dataset_name", "synthetic"])


def _gloo_rank(path):
    """A rank of a gloo world of 2 on one card: 2 eager DP steps of
    ``_small_run`` on its own ids; rank 0 saves its weights."""
    import pathlib

    import torch.distributed as dist

    from molkgnn_torch.parallel.data_parallel import make_mesh

    path = pathlib.Path(path)
    mesh = make_mesh(2, backend="gloo")
    rank = dist.get_rank()
    t = _small_run(path, f"rank{rank}", mesh=mesh)
    for ids in np.load(path / "ids.npy")[:, rank]:
        t._step_ids(ids)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in t.model.state_dict().items()},
                   path / "rank0.pt")


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_on_one_card_equal_a_plain_dp_step(tmp_path):
    """Two ranks sharing the card over gloo (CUDA tensors), 2 eager steps,
    against one process that averages both sub-batches' gradients and
    BatchNorm statistics and steps: parameters within 1e-5."""
    _needs_card()
    from molkgnn_torch.parallel import launch
    from molkgnn_torch.parallel.data_parallel import batch_norm_buffers
    from molkgnn_torch.training.optim import fill_missing_grads

    rng = np.random.default_rng(2)
    ids = rng.choice(256, (2, 2, 32)).astype(np.int32)
    np.save(tmp_path / "ids.npy", ids)
    launch.spawn(_gloo_rank, 2, args=(str(tmp_path),), backend="gloo")
    plain = _small_run(tmp_path, "plain")
    bn = batch_norm_buffers(plain.model)
    for step in range(2):
        start, masks = [b.clone() for b in bn], plain.dropout_rng.get_state()
        grads, stats = [], []
        for r in range(2):
            for b, v in zip(bn, start):
                b.copy_(v)
            plain.dropout_rng.set_state(masks)
            batch = plain._gather(plain._device_data,
                                  torch.as_tensor(ids[step, r]).cuda(),
                                  plain.spec)
            plain._loss(batch).backward()
            fill_missing_grads(plain._params)
            grads.append([p.grad.clone() for p in plain._params])
            stats.append([b.clone() for b in bn])
        with torch.no_grad():
            for p, g0, g1 in zip(plain._params, *grads):
                p.grad.copy_((g0 + g1) / 2)
            for b, s0, s1 in zip(bn, *stats):
                b.copy_((s0 + s1) / 2)
        plain._update()
    got = torch.load(tmp_path / "rank0.pt")
    want = plain.model.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        torch.testing.assert_close(v.cuda(), want[k], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ model parallel
def _halo_batches(t, ids):
    """Host batches of the graph ids ``ids`` [S, B] under ``t``'s spec."""
    from molkgnn_torch.graphs.batch import batch_graphs

    return [batch_graphs([t.dataset.graphs[i] for i in row], t.spec)
            for row in ids]


def _halo_gloo_rank(path):
    """A shard of a gloo world of 2 on one card: 2 eager halo steps of
    ``_small_run`` (dropout 0) on host-partitioned batches; rank 0 saves
    its weights and scorer launches."""
    import pathlib

    import torch.distributed as dist

    from molkgnn_torch.parallel.data_parallel import make_mesh

    path = pathlib.Path(path)
    mesh = make_mesh(2, backend="gloo")
    t = _small_run(path, f"rank{dist.get_rank()}", dropout=0.0, mesh=mesh,
                   model_parallel="halo")
    before = ss.grouped_support_score.launches
    for batch in _halo_batches(t, np.load(path / "ids.npy")):
        t._step(t._mine(t._partition([batch])))
    if dist.get_rank() == 0:
        torch.save({"state": {k: v.cpu()
                              for k, v in t.model.state_dict().items()},
                    "launches": ss.grouped_support_score.launches - before},
                   path / "rank0.pt")


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_halo_steps_equal_one_device(tmp_path):
    """Two halo shards sharing the card over gloo (the exchanges on CUDA
    tensors), 2 eager steps on the same batches as one device's Trainer
    (dropout 0): parameters within 1e-5; 2 scorer launches a step on a
    rank."""
    _needs_card()
    from molkgnn_torch.parallel import launch

    ids = np.random.default_rng(3).choice(256, (2, 32)).astype(np.int32)
    np.save(tmp_path / "ids.npy", ids)
    launch.spawn(_halo_gloo_rank, 2, args=(str(tmp_path),), backend="gloo")
    plain = _small_run(tmp_path, "plain", dropout=0.0)
    for batch in _halo_batches(plain, ids):
        plain._step(batch.to("cuda"))
    got = torch.load(tmp_path / "rank0.pt")
    assert got["launches"] == 2 * 2
    want = plain.model.state_dict()
    assert set(got["state"]) == set(want)
    for k, v in got["state"].items():
        torch.testing.assert_close(v.cuda(), want[k], rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_world_one_halo_replayed_equals_eager(tmp_path):
    """A world-1 NCCL halo mesh with device sampling, eager against the
    captured step (scan_steps=8, the exchanges inside the graph; dropout
    on, whose masks replays draw as eager steps do): losses within 1e-5
    relative, parameters within 1e-5, 2 launches a step; the eager halo
    run against one device's device-sampled run, within 1e-5."""
    _needs_card()
    import torch.distributed as dist

    from molkgnn_torch.parallel.data_parallel import make_mesh

    mesh = make_mesh(1)
    try:
        runs = {}
        for name, k, m in (("eager", 1, mesh), ("graphed", 8, mesh),
                           ("single", 1, None)):
            t = _small_run(tmp_path, name, scan_steps=k, mesh=m,
                           device_sampling=True, dropout=0.0,
                           model_parallel=None if m is None else "halo")
            before = ss.grouped_support_score.launches
            t.fit()
            runs[name] = (t, ss.grouped_support_score.launches - before)
        eager, graphed, single = (runs[n][0] for n in
                                  ("eager", "graphed", "single"))
        assert graphed._graph is not None and eager._graph is None
        assert eager.step == graphed.step == single.step == 8
        np.testing.assert_allclose(graphed.step_losses, eager.step_losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(eager.step_losses, single.step_losses,
                                   rtol=1e-5)
        assert _max_param_diff(eager, graphed) <= 1e-5
        assert _max_param_diff(eager, single) <= 1e-5
        assert runs["graphed"][1] == 2 * 8 + 2
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_spherenet_learned_node_vector_fp64_matches_cpu():
    """SphereNet(use_node_features=False) in float64 on the card against
    the CPU, same weights and batch: within 1e-9."""
    _needs_card()
    import dataclasses

    from molkgnn_torch.graphs.geometric import batch_points
    from molkgnn_torch.models.spherenet import SphereNet
    from molkgnn_torch.training.model import GNNModel

    graphs, spec, _ = _point_setup("spherenet")
    gen = torch.Generator().manual_seed(13)
    model = GNNModel(SphereNet(cutoff=POINT_CUTOFF, use_node_features=False,
                               generator=gen, **POINT_SMALL["spherenet"]),
                     ffn_dropout_rate=0.0, generator=gen)
    assert "gnn_model.init_e.node_embedding.node_embedding" in (
        model.state_dict())
    batch = batch_points(graphs[:8], spec)
    batch = dataclasses.replace(batch, pos=batch.pos.double(),
                                y=batch.y.double())
    model = model.double().eval()
    with torch.no_grad():
        want = model(batch)
        got = model.cuda()(batch.to("cuda"))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("use_kernel", [True, False])
def test_cuda_bf16_flagship_forward_matches_cpu(use_kernel):
    """The flagship (4 layers) with matmul_dtype=torch.bfloat16 on the
    card against the CPU, same weights, 64 tie-free molecules: the eval
    embeddings within 1e-5 on the kernel route (only the edge score, on
    the raw edge features, is rounded) and within 1e-4 on the plain route,
    where the card's last-bit differences in the normalised node features
    flip some bf16 roundings (tests/test_torch_port_halo_partition.py::
    test_bf16_products_amplify_last_bit_changes: more than 1e-5 on the
    CPU alone); both more than 1e-4 from the fp32 products. With TF32 off,
    cuBLAS's fp32 products on the rounded operands differ from the CPU's
    only in summation order."""
    _needs_card()
    assert not torch.backends.cuda.matmul.allow_tf32
    from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
    from molkgnn_torch.models.kgnn import MolKGNNNet

    graphs = _tie_free_graphs(64, seed=14)
    batch = batch_graphs(graphs, spec_for_graphs(graphs, 64))
    model = MolKGNNNet(use_kernel=use_kernel, matmul_dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(15)).eval()
    with torch.no_grad():
        want = model(batch)
        card = model.cuda()
        before = ss.grouped_support_score.launches
        got = card(batch.to("cuda"))
        torch.cuda.synchronize()
        launched = ss.grouped_support_score.launches - before
        card.gnn.layers.apply(lambda m: setattr(m, "matmul_dtype", None))
        full = card(batch.to("cuda"))
    assert launched == (4 if use_kernel else 0)
    tol = 1e-5 if use_kernel else 1e-4
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)
    assert float((full - got).abs().max()) > 1e-4


# The segment sum (ops/segment.py, csrc/segment_sum.cu): cases of (rows of
# values, terms, segments, trailing shape, masked share, elements the values
# start past a 16-byte boundary).
SEGMENT_CASES = {
    "message_passing": (2000, 6000, 2000, (110,), 0.1, 0),
    "pooling": (3000, 3000, 64, (32,), 0.2, 0),
    "one_column": (500, 900, 700, (), 0.0, 0),  # [N] sums, empty segments
    "three_dims": (300, 800, 50, (4, 6), 0.5, 0),
    "no_terms": (10, 0, 5, (3,), 0.0, 0),
    "width_1": (500, 900, 700, (1,), 0.1, 0),
    "width_3": (400, 1200, 300, (3,), 0.1, 0),
    "width_128": (2000, 5000, 1500, (128,), 0.1, 0),
    "perms_width_5500": (48, 48, 4, (5500,), 0.0, 0),
    "unaligned_32": (3000, 3000, 64, (32,), 0.2, 1),
    "unaligned_110": (2000, 6000, 2000, (110,), 0.1, 1),
    "long_segments": (5000, 200_000, 100, (32,), 0.05, 0),
    "all_masked": (300, 800, 50, (110,), 1.0, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_cuda_segment_sum_bit_equal_to_plain(case, dtype):
    """The kernel against its plain version on CPU copies of the same
    inputs: the plan keeps each segment's terms in list order, and both add
    them in that order from zero, so the sums are bit-equal (fp32 and
    fp64), masked terms and empty segments included, at widths 1 to 5500,
    from values that start off a 16-byte boundary (narrower vector loads),
    over segments of 2,000 terms. One launch, counted; the plan built by
    the plan kernel equals the plain plan."""
    _needs_card()
    from molkgnn_torch.ops import segment as sg

    rows, terms, segs, tail, masked, offset = SEGMENT_CASES[case]
    rng = np.random.default_rng(sorted(SEGMENT_CASES).index(case))
    values = torch.from_numpy(rng.standard_normal((rows,) + tail)).to(dtype)
    ids = torch.from_numpy(rng.integers(0, segs, terms))
    src = torch.from_numpy(rng.integers(0, rows, terms))
    mask = torch.from_numpy(rng.random(terms) >= masked)
    plans = sg.segment_plan.launches
    plan = sg.segment_plan(ids.cuda(), segs, mask.cuda(), gather=src.cuda())
    assert sg.segment_plan.launches == plans + 1
    want = sg.segment_sum_plain(values, plan.row.cpu(), plan.rowptr.cpu())
    card = torch.empty(values.numel() + offset, dtype=dtype, device="cuda")
    card = card[offset:].view(values.shape)
    card.copy_(values)
    assert (card.data_ptr() % 16 == 0) == (offset == 0)
    before = sg.segment_sum.launches
    got = sg.segment_sum(card, plan)
    torch.cuda.synchronize()
    assert sg.segment_sum.launches == before + (1 if got.numel() else 0)
    assert got.dtype == dtype and got.shape == (segs,) + tail
    assert torch.equal(got.cpu(), want)
    # The plan built on the card equals the one built on the CPU.
    cpu_plan = sg.segment_plan(ids, segs, mask, gather=src)
    for a, b in zip(plan, cpu_plan):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("masked,gathered", [(False, False), (True, False),
                                             (False, True), (True, True)])
@pytest.mark.parametrize("index", [torch.int32, torch.int64])
@pytest.mark.parametrize("segments", [255, 256, 65_535, 65_536])
def test_cuda_segment_plan_equals_plain(segments, index, masked, gathered):
    """The plan kernel's row, rowptr and ids against the plain plan's, as
    integers, at the digit boundaries of its passes (S = 255 and 65,535 are
    the last of 1 and 2 passes), int32 and int64 ids and gathers, with and
    without a mask, over five tiles of keys that reach the dump segment S.
    One plan counted."""
    _needs_card()
    from molkgnn_torch.ops import segment as sg

    rng = np.random.default_rng(segments + 7 * masked + 3 * gathered)
    terms = 4 * sg.PLAN_TILE + 321
    ids = torch.from_numpy(rng.integers(0, segments, terms)).to(index)
    ids[:5] = segments - 1
    mask = (torch.from_numpy(rng.random(terms) >= 0.3) if masked else None)
    gather = (torch.from_numpy(rng.integers(0, 10**6, terms)).to(index)
              if gathered else None)
    want = sg.segment_plan_plain(ids, segments, mask, gather)
    cuda = lambda t: None if t is None else t.cuda()  # noqa: E731
    before = sg.segment_plan.launches
    got = sg.segment_plan(ids.cuda(), segments, cuda(mask), cuda(gather))
    torch.cuda.synchronize()
    assert sg.segment_plan.launches == before + 1
    for field, g, w in zip(sg.SegmentPlan._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert torch.equal(g.cpu(), w), field


@pytest.mark.cuda
def test_cuda_segment_plan_in_graph_capture_equals_eager():
    """A plan built inside a CUDA graph capture, replayed, equals the eager
    plan of the same inputs; refilled inputs and a second replay give the
    eager plan of the new ones: the kernels take their shapes from E and S
    and synchronise nothing with the host."""
    _needs_card()
    from molkgnn_torch.ops import segment as sg

    rng = np.random.default_rng(31)
    terms, segs = 3 * sg.PLAN_TILE + 5, 40_000

    def inputs():
        return (torch.from_numpy(rng.integers(0, segs, terms)).cuda(),
                torch.from_numpy(rng.random(terms) >= 0.2).cuda(),
                torch.from_numpy(rng.integers(0, 5000, terms)).cuda())

    static = inputs()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sg.segment_plan(static[0], segs, static[1], static[2])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sg.segment_plan(static[0], segs, static[1], static[2])
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        eager = sg.segment_plan(static[0], segs, static[1], static[2])
        for g, w in zip(captured, eager):
            assert torch.equal(g, w)
        for t, new in zip(static, inputs()):
            t.copy_(new)


@pytest.mark.cuda
@pytest.mark.parametrize("stem", ["segment_sum", "segment_plan"])
def test_cuda_segment_sum_without_the_library_raises(monkeypatch, stem):
    """A CUDA tensor goes to the kernels or the call raises: with the sum's
    or the plan builder's library unavailable nothing falls back to
    index_add_ or to the torch sort, and nothing is counted."""
    _needs_card()
    from molkgnn_torch.ops import _build
    from molkgnn_torch.ops import segment as sg

    built = _build.library

    def missing(name):
        if name == stem:
            raise OSError(f"lib{name}.so: cannot open shared object file")
        return built(name)

    monkeypatch.setattr(_build, "library", missing)
    ids = torch.tensor([0, 1, 1], device="cuda")
    before = (sg.segment_sum.launches, sg.segment_plan.launches)
    with pytest.raises(OSError):
        sg.segment_sum_nodes(torch.ones(3, 2, device="cuda"), ids, 2)
    assert sg.segment_sum.launches == before[0]
    assert sg.segment_plan.launches == before[1] + (stem == "segment_sum")


@pytest.mark.cuda
def test_cuda_segment_plan_refuses_what_it_does_not_take():
    """Ids that are not integers, a mask that is not bool or a gather of
    another length raise before any launch, uncounted."""
    _needs_card()
    from molkgnn_torch.ops import segment as sg

    ids = torch.tensor([0, 1, 1], device="cuda")
    before = sg.segment_plan.launches
    with pytest.raises(TypeError):
        sg.segment_plan(ids.float(), 2)
    with pytest.raises(TypeError):
        sg.segment_plan(ids, 2, mask=torch.ones(3, device="cuda"))
    with pytest.raises(TypeError):
        sg.segment_plan(ids, 2, gather=torch.arange(4, device="cuda"))
    assert sg.segment_plan.launches == before


def _with_ties(n, seed=21):
    """Synthetic molecules of chip_smoke.py's set (random spanning trees
    with extra bonds): permutation-argmax ties included."""
    from molkgnn_torch.data.synthetic import random_dataset

    return random_dataset(seed=seed, num_graphs=n)


@pytest.mark.cuda
def test_cuda_flagship_forward_and_step_repeat_bit_equal():
    """On molecules with ties, the flagship forward twice and one train
    step twice from the same state give the same bits: every sum of two or
    more terms runs in a fixed order (the segment-sum kernel), so no tie
    flips between runs. The kernel launches on both."""
    _needs_card()
    import copy

    from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
    from molkgnn_torch.ops import segment as sg
    from molkgnn_torch.training.model import bce_with_logits_loss

    from molkgnn_torch.models.kgnn import MolKGNNNet
    from molkgnn_torch.training.model import GNNModel

    graphs = _with_ties(128)
    batch = batch_graphs(graphs, spec_for_graphs(graphs, 128)).to("cuda")
    gen = torch.Generator().manual_seed(22)
    model = GNNModel(MolKGNNNet(use_kernel=True, generator=gen),
                     ffn_dropout_rate=0.0, generator=gen).cuda()
    with torch.no_grad():
        model.eval()
        before = sg.segment_sum.launches
        runs = [model(batch)[0] for _ in range(2)]
    assert sg.segment_sum.launches - before == 2 * 5  # 4 layers + pooling
    assert torch.equal(runs[0], runs[1])

    model.train()
    start = copy.deepcopy(model.state_dict())
    states = []
    for _ in range(2):
        model.load_state_dict(start)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        logits = model(batch)[0]
        loss = bce_with_logits_loss(logits, batch.y, batch.graph_mask)
        opt.zero_grad()
        loss.backward()
        opt.step()
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


# The scorer's backward: kernel cases beside CASES' ragged, permutations and
# flagship_nhop. The flagship's layer 0 (K = 28 * d) and P outside
# {1, 2, 6, 12} at the flagship's widths (db's passes of PC permutations).
BACKWARD_CASES = {
    "ragged": CASES["ragged"],
    "permutations": CASES["permutations"],
    "flagship_nhop": CASES["flagship_nhop"],
    "flagship_layer0": [
        (19232, 28, 10, 1), (13640, 56, 20, 2), (8144, 84, 30, 6),
        (7064, 112, 50, 12),
    ],
    "other_p": [(3000, 330, 30, 3), (2000, 440, 50, 7), (500, 220, 20, 24)],
    # The tensor-core kernels' edges: P * L not a multiple of 8 (N = 180,
    # 21, 5), M not a multiple of 64 (a ragged last row tile, a warpgroup
    # with no row), K below one 32-column chunk (layer 0's 28, and 5).
    "pl_not_multiple_of_8": [(3000, 330, 30, 6), (300, 21, 7, 3),
                             (77, 9, 5, 1)],
    "m_not_multiple_of_64": [(1, 110, 10, 1), (65, 220, 20, 2),
                             (129, 330, 30, 6), (191, 440, 50, 12)],
    "k_below_one_tile": [(2000, 28, 10, 1), (1500, 28, 50, 12),
                         (300, 5, 20, 2)],
}


def _backward_operands(case, seed=9):
    """a and b as on the model's path (unit vectors along k, as
    ``_unit_operands``), g standard normal and idx uniform in [0, P), on the
    card: the backward is defined for any argmax, so the cases need no
    forward."""
    rng = np.random.default_rng(seed)
    shapes = BACKWARD_CASES[case]
    a, b = _unit_operands(rng, shapes)
    g = [torch.from_numpy(rng.standard_normal((m, l))).float().cuda()
         for m, _, l, _ in shapes]
    idx = [torch.from_numpy(rng.integers(0, p, (m, l), dtype=np.int32))
           .cuda() for m, _, l, p in shapes]
    return a, b, g, idx


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BACKWARD_CASES))
def test_cuda_backward_kernels_match_plain(case):
    """The backward kernels against ``support_score_backward_plain`` on the
    same CUDA tensors: max |diff| <= 1e-5 * max(1, max |plain|) for each
    gradient. The kernels add each output's terms in their own fixed order
    (da over l, db over m in ranges of rows), cuBLAS in another, hence the
    tolerance; it is relative to the gradient's largest value, since both
    sides round relative to their terms' size and an element whose terms
    cancel keeps an error of that size (at the flagship's layer 0, db sums
    19,232 rows: each side stands about 2e-5 from the fp64 sum, on values up
    to about 100). On failure the message gives both sides' largest
    distance from the plain version in fp64. Every group takes da; every
    other group takes db, and one call counts one launch."""
    _needs_card()
    a, b, g, idx = _backward_operands(case)
    need_a = [True] * len(a)
    need_b = [i % 2 == 0 for i in range(len(a))]
    before = ss.support_score_backward.launches
    das, dbs = ss.support_score_backward(a, b, g, idx, need_a, need_b)
    torch.cuda.synchronize()
    assert ss.support_score_backward.launches == before + 1
    for i in range(len(a)):
        want = ss.support_score_backward_plain(
            a[i], b[i], g[i], idx[i], need_a[i], need_b[i])
        exact = ss.support_score_backward_plain(
            a[i].double(), b[i].double(), g[i].double(), idx[i], need_a[i],
            need_b[i])
        for got, w, x in zip((das[i], dbs[i]), want, exact):
            if w is None:
                assert got is None
                continue
            assert got.shape == w.shape and got.dtype == torch.float32
            assert torch.isfinite(got).all()
            scale = max(1.0, w.abs().max().item())
            ok = (got - w).abs().max().item() <= 1e-5 * scale
            assert ok, (case, i, scale, (got - w).abs().max().item(),
                        (got.double() - x).abs().max().item(),
                        (w.double() - x).abs().max().item())


# The longest chain of tensor-core accumulations into one sum: da adds
# 3 products a step of 8 columns n' over its padded P * L (steps in pairs);
# db adds 3 a step of 8 rows over a range of at most 32 c P rows, c being
# kDbRangeChunks of csrc/support_score_bwd.cu.
DB_RANGE_CHUNKS = 4


def _chain(shape, what):
    _, _, l, p = shape
    if what == "da":
        steps = -(-p * l // 8)
        return 3 * (steps + steps % 2)
    return 3 * 32 * DB_RANGE_CHUNKS * p // 8


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship_layer0", "flagship_nhop"])
def test_cuda_backward_kernels_as_accurate_as_fp32(case):
    """The flagship's grouped calls as a train step makes them (layer 0's
    19,232-row P = 1 group, the N-hop layer's degree-4 group at K = 440,
    L = 50, P = 12, and the two between), held against x64, the plain
    route in fp64 on the same operands. For each group and gradient the
    kernels' max |x - x64| is at most twice the plain route's in fp32
    (cuBLAS, TF32 off) plus one fp32 ulp of max |x64| (2^-23 of it) for each
    tensor-core accumulation in the longest chain of one sum (``_chain``):
    the tensor cores round each accumulation toward zero, so the error
    grows with the chain, and the 3xTF32 split adds little to fp32's own.
    Plain TF32 (hi*hi alone, ``support_score_backward_3xtf32`` with one
    term) lies outside that bound.
    """
    _needs_card()
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a, b, g, idx = _backward_operands(case, seed=17)
        n = len(a)
        das, dbs = ss.support_score_backward(a, b, g, idx, [True] * n,
                                             [True] * n)
        for i in range(n):
            shape = tuple(BACKWARD_CASES[case][i])
            plain = ss.support_score_backward_plain(a[i], b[i], g[i], idx[i])
            tf32 = ss.support_score_backward_3xtf32(a[i], b[i], g[i], idx[i],
                                                    terms=1)
            exact = ss.support_score_backward_plain(
                a[i].double(), b[i].double(), g[i].double(), idx[i])
            for what, got, w, w32, x in zip(("da", "db"), (das[i], dbs[i]),
                                            plain, tf32, exact):
                def err(y):
                    return (y.double() - x).abs().max().item()

                limit = (2 * err(w) + _chain(shape, what) * 2.0 ** -23
                         * x.abs().max().item())
                assert err(got) <= limit, (case, i, what, err(got), err(w),
                                           limit)
                assert err(w32) > limit, (case, i, what, err(w32), limit)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [17, 18])
@pytest.mark.parametrize("case", ["flagship_layer0", "flagship_nhop"])
def test_cuda_backward_kernels_within_twice_fp32(case, seed):
    """The flagship's grouped calls as a train step makes them, held
    against x64, the plain route in fp64 on the same operands: for each
    group and gradient the kernels' max |x - x64| is at most twice the
    plain route's in fp32 (cuBLAS, TF32 off) plus one fp32 ulp of max |x64|
    (2^-23 of it). The kernels add each wgmma accumulator, which rounds
    toward zero, into a sum rounded to nearest every few k8 steps, so no
    chain of tensor-core accumulations grows with P or with the rows of a
    range."""
    _needs_card()
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a, b, g, idx = _backward_operands(case, seed=seed)
        n = len(a)
        das, dbs = ss.support_score_backward(a, b, g, idx, [True] * n,
                                             [True] * n)
        for i in range(n):
            plain = ss.support_score_backward_plain(a[i], b[i], g[i], idx[i])
            exact = ss.support_score_backward_plain(
                a[i].double(), b[i].double(), g[i].double(), idx[i])
            for what, got, w, x in zip(("da", "db"), (das[i], dbs[i]),
                                       plain, exact):
                def err(y):
                    return (y.double() - x).abs().max().item()

                limit = 2 * err(w) + 2.0 ** -23 * x.abs().max().item()
                assert err(got) <= limit, (case, seed, i, what, err(got),
                                           err(w), limit)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship_nhop", "flagship_layer0",
                                  "ragged"])
def test_cuda_backward_kernels_one_gradient_a_group(case):
    """Groups that take only da, only db, or both, in one call (fixed
    kernel sets' b take no gradient): each gradient within 1e-5 * max(1,
    max |plain|) of ``support_score_backward_plain``, the others None."""
    _needs_card()
    a, b, g, idx = _backward_operands(case, seed=15)
    need_a = [i % 3 != 0 for i in range(len(a))]
    need_b = [i % 3 != 1 for i in range(len(a))]
    before = ss.support_score_backward.launches
    das, dbs = ss.support_score_backward(a, b, g, idx, need_a, need_b)
    torch.cuda.synchronize()
    assert ss.support_score_backward.launches == before + 1
    for i in range(len(a)):
        want = ss.support_score_backward_plain(
            a[i], b[i], g[i], idx[i], need_a[i], need_b[i])
        for got, w in zip((das[i], dbs[i]), want):
            if w is None:
                assert got is None
                continue
            scale = max(1.0, w.abs().max().item())
            assert (got - w).abs().max().item() <= 1e-5 * scale, (case, i)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(19232, 28, 10, 1), (13640, 56, 20, 2),
                                   (8144, 330, 30, 6), (100, 440, 50, 12)])
def test_cuda_fused_backward_matches_plain(shape):
    """G = 1 through ``fused_support_score``: its backward (one counted
    call of the kernels) against ``support_score_backward_plain`` on the
    forward's own argmaxes, within 1e-5 * max(1, max |plain|) each."""
    _needs_card()
    (a,), (b,) = _unit_operands(np.random.default_rng(16), [shape])
    g = torch.randn(shape[0], shape[2], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    best, idx = ss.fused_support_score(ta, tb)
    before = ss.support_score_backward.launches
    (best * g).sum().backward()
    assert ss.support_score_backward.launches == before + 1
    for got, w in zip((ta.grad, tb.grad),
                      ss.support_score_backward_plain(a, b, g, idx)):
        scale = max(1.0, w.abs().max().item())
        assert (got - w).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["flagship_nhop", "ragged"])
def test_cuda_backward_repeats_bit_equal(case):
    """Two calls of the backward kernels on the same inputs give the same
    bits: no atomics, every sum in a fixed order."""
    _needs_card()
    a, b, g, idx = _backward_operands(case, seed=10)
    runs = [ss.support_score_backward(a, b, g, idx) for _ in range(2)]
    for x, y in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_cuda_backward_in_graph_capture_equals_eager():
    """The backward captured in a CUDA graph and replayed equals the eager
    call bit for bit, and again after the inputs are refilled: the kernels
    take their sizes from the shapes and synchronise nothing with the
    host. The capture counts its launch, as the Trainer's does."""
    _needs_card()
    static = _backward_operands("flagship_nhop", seed=11)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.support_score_backward(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = ss.support_score_backward.launches
    with torch.cuda.graph(graph):
        captured = ss.support_score_backward(*static)
    assert ss.support_score_backward.launches == before + 1
    for seed in (12, 13):
        graph.replay()
        torch.cuda.synchronize()
        eager = ss.support_score_backward(*static)
        for x, y in zip(captured[0] + captured[1], eager[0] + eager[1]):
            assert torch.equal(x, y)
        for ts, new in zip(static, _backward_operands("flagship_nhop",
                                                      seed=seed)):
            for t, n in zip(ts, new):
                t.copy_(n)


@pytest.mark.cuda
def test_cuda_backward_without_the_library_raises(monkeypatch):
    """A CUDA tensor goes to the backward kernels or the call raises: with
    their library unavailable nothing falls back to the plain version, and
    nothing is counted."""
    _needs_card()
    from molkgnn_torch.ops import _build

    built = _build.library

    def missing(name):
        if name == "support_score_bwd":
            raise OSError(f"lib{name}.so: cannot open shared object file")
        return built(name)

    monkeypatch.setattr(_build, "library", missing)
    ss._backward_scratch.cache_clear()
    a, b, g, idx = _backward_operands("permutations")
    before = ss.support_score_backward.launches
    with pytest.raises(OSError):
        ss.support_score_backward(a, b, g, idx)
    ta = [x.clone().requires_grad_() for x in a]
    outs = ss.grouped_support_score(ta, b)
    with pytest.raises(OSError):
        sum(best.sum() for best, _ in outs).backward()
    assert ss.support_score_backward.launches == before


@pytest.mark.cuda
def test_cuda_fused_scorer_backward_goes_through_the_kernels():
    """The fused scorer (G = 1, ``KernelConv(use_kernel=True)``) takes the
    same backward op: one counted call, gradients of sum(best * g) within
    1e-4 of autograd through the plain version (the upstream gradient zero
    where the top two scores are within 1e-4)."""
    _needs_card()
    (a,), (b,) = _unit_operands(np.random.default_rng(14),
                                [(7064, 112, 50, 12)])
    sc = torch.einsum("mk,pkl->mlp", a.double(), b.double())
    top2 = sc.topk(2, dim=2).values
    g = torch.randn(sc.shape[:2], device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    g = torch.where(top2[..., 0] - top2[..., 1] > 1e-4, g, 0.0)
    ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = ss.support_score_backward.launches
    best, _ = ss.fused_support_score(ta, tb)
    (best * g).sum().backward()
    assert ss.support_score_backward.launches == before + 1
    for got, want in zip((ta.grad, tb.grad), _plain_grads([a], [b], [g])):
        assert (got - want).abs().max().item() <= 1e-4
