"""The work counters against hand counts at the flagship's shapes."""

import pytest

from bench_port import files
from bench_port.roofline import (
    least_seconds,
    scorer_backward_work,
    scorer_forward_work,
)
from bench_port.reference import kgnn, schnet

# The flagship's degree buckets at its batch-1024 capacity (rows), its
# kernels and orderings a degree; K = 28 d at layer 0, 110 d after.
ROWS = (19232, 13640, 8144, 7064)
KERNELS = (10, 20, 30, 50)
PERMS = (1, 2, 6, 12)


def _capacity_shapes():
    counts = {f"deg{d}": m for d, m in enumerate(ROWS, 1)}
    return kgnn.scorer_shapes(files.config("kgnn-flagship"), counts)


def test_scorer_shapes_follow_the_layers():
    layers = _capacity_shapes()
    assert len(layers) == 4
    for i, layer in enumerate(layers):
        width = 28 if i == 0 else 110
        assert layer == [(m, width * d, l, p) for d, (m, l, p)
                         in enumerate(zip(ROWS, KERNELS, PERMS), 1)]


def test_scorer_forward_work_at_capacity():
    ops, nbytes = scorer_forward_work(
        [s for layer in _capacity_shapes() for s in layer])
    assert ops == pytest.approx(16.21e9, rel=5e-4)
    assert nbytes == pytest.approx(180.4e6, rel=5e-4)
    assert least_seconds(ops, nbytes)[1] == "bytes"


def test_scorer_backward_work_at_capacity():
    ops, nbytes = scorer_backward_work(
        [s for layer in _capacity_shapes() for s in layer])
    assert ops == pytest.approx(4.13e9, rel=5e-4)
    assert nbytes == pytest.approx(326.8e6, rel=5e-4)


def test_least_seconds_takes_the_larger_bound():
    assert least_seconds(495e12, 0.0) == (1.0, "operations")
    assert least_seconds(0.0, 3.35e12) == (1.0, "bytes")


def test_kgnn_model_flops_by_hand():
    """One layer, one degree, one kernel: forward 2 M K L P + 2 M d Fe L P
    + 2 M F L; backward 4 M K L + 2 M d Fe L + 4 M F L; the readout and
    head three times their forward."""
    cfg = {"encoder": {"num_layers": 1, "kernels_1hop": [0, 3, 0, 0],
                       "kernels_nhop": [0, 3, 0, 0], "node_dim": 5,
                       "edge_dim": 2, "graph_embedding_dim": 4}}
    c = {"deg1": 0, "deg2": 7, "deg3": 0, "deg4": 0, "nodes": 11,
         "graphs": 2}
    m, f, d, fe, nk, p = 7, 5, 2, 2, 3, 2
    conv = (2 * m * d * f * nk * p + 2 * m * d * fe * nk * p
            + 2 * m * f * nk + 4 * m * d * f * nk + 2 * m * d * fe * nk
            + 4 * m * f * nk)
    head = 3 * (2 * 11 * (3 * 4 + 4 * 4) + 2 * 2 * 4)
    assert kgnn.model_flops(cfg, c) == conv + head


def test_schnet_model_flops_by_hand():
    cfg = {"encoder": {"num_layers": 2, "hidden_channels": 4,
                       "num_filters": 6, "num_gaussians": 3,
                       "out_channels": 2}}
    e, n, b = 10, 5, 2
    fwd_layer = (2 * e * 3 * 6 + 2 * e * 6 * 6
                 + 2 * n * (4 * 6 + 6 * 4 + 4 * 4))
    bwd_layer = 2 * e * 3 * 6 + 2 * (fwd_layer - 2 * e * 3 * 6)
    readout = 2 * n * (4 * 2 + 2 * 2) + 2 * b * 2
    got = schnet.model_flops(cfg, {"pairs": e, "nodes": n, "graphs": b})
    assert got == 2 * (fwd_layer + bwd_layer) + 3 * readout
