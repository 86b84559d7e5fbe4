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

# (M, K, L, P): the ragged shapes of tests/test_pallas.py's grouped case,
# plus P > 12 (two permutation passes) and L > 64 (two column tiles).
SHAPES = [
    (37, 28, 10, 1), (61, 56, 20, 2), (23, 84, 30, 6), (49, 112, 50, 12),
    (1, 3, 70, 13), (130, 500, 129, 25),
]


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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The kernel against its plain version in one grouped launch: best
    within 1e-5, argmax equal where the top two scores are > 1e-4 apart."""
    _needs_card()
    a_list, b_list = _unit_operands(np.random.default_rng(1), SHAPES)
    before = ss.grouped_support_score.launches
    outs = ss.grouped_support_score(a_list, b_list)
    torch.cuda.synchronize()
    assert ss.grouped_support_score.launches == before + 1
    for (best, idx), a, b in zip(outs, a_list, b_list):
        want_best, want_idx = ss.support_score_plain(a, b)
        torch.testing.assert_close(best, want_best, rtol=1e-5, atol=1e-5)
        sc = torch.einsum("mk,pkl->mlp", a.double(), b.double())
        top2 = sc.topk(min(2, sc.shape[2]), dim=2).values
        clear = (top2[..., 0] - top2[..., -1] > 1e-4) | (sc.shape[2] == 1)
        assert torch.equal(idx[clear], want_idx[clear])


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
