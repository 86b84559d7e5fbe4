"""The plain reference against ``molkgnn_torch`` on the CPU, in float64, on
tie-free molecules (where the permutation argmax has one answer): the
check's own path, the program's first train steps through the call the
window uses against the reference's redraw of the same ids, masks and
updates, then the program's validation logits against the reference's
eval forward of the program's state."""

import dataclasses

import numpy as np
import pytest
import torch

from bench_port import check, files, program
from bench_port.reference.common import make_weights
from bench_port.traffic import Molecule, Traffic
from molkgnn_torch.data.synthetic import tie_free_molgraph

SEED = 2 ** 31 + 77


def _tie_free_traffic(n_mol=24, n_entries=120, actives=20, seed=5):
    rng = np.random.default_rng(seed)
    mols = []
    for _ in range(n_mol):
        g = tie_free_molgraph(rng)
        mols.append(Molecule(x=g.x, p=g.p * 2.0, edge_index=g.edge_index,
                             edge_attr=g.edge_attr,
                             atomic_num=g.atomic_num))
    labels = np.zeros(n_entries, np.float32)
    labels[rng.choice(n_entries, actives, replace=False)] = 1.0
    perm = rng.permutation(n_entries)
    n_tr, n_va = int(n_entries * 0.8), int(n_entries * 0.1)
    split = {"train": np.sort(perm[:n_tr]),
             "valid": np.sort(perm[n_tr:n_tr + n_va]),
             "test": np.sort(perm[n_tr + n_va:])}
    return Traffic(mols, rng.permutation(np.arange(n_entries) % n_mol),
                   labels, split)


def _double_device_data(tr):
    dd = tr._device_data
    fields = {f.name for f in dataclasses.fields(dd)}
    cast = {}
    for name in ("x", "p", "edge_attr", "y", "pos"):
        if name in fields:
            cast[name] = getattr(dd, name).double()
    if "deg_ea" in fields:
        cast["deg_ea"] = tuple(a.double() for a in dd.deg_ea)
    tr._device_data = dataclasses.replace(dd, **cast)


@pytest.mark.parametrize("config", ["kgnn-flagship", "schnet-6x128"])
def test_check_path_matches_the_program_in_float64(config, tmp_path):
    cfg = files.config(config)
    ref = files.reference(cfg["family"])
    tspec = dict(files.traffic("train-b1024"), batch_size=16)
    data = _tie_free_traffic()
    dev = torch.device("cpu")
    weights = make_weights(ref.param_specs(cfg), SEED, dev, torch.float64)
    ds = program.dataset(data, cfg, tspec["batch_size"])
    tr = program.trainer(cfg, tspec, ds, weights, SEED % 2 ** 63, dev,
                         str(tmp_path), dtype=torch.float64)
    _double_device_data(tr)
    step = program.step_call(tr)
    losses = []
    for k in range(3):
        losses.append(float(step()))
        if k == 0:
            first = check.leaf_norms(program.first_gradients(tr))
    params = dict(tr.model.named_parameters())
    change = check.leaf_norms({n: params[n].detach() - weights[n]
                               for n in params})
    r_losses, r_first, r_change, r_after = check.reference_steps(
        ref, cfg, tspec, data, weights, SEED % 2 ** 63, dev, 3)
    np.testing.assert_allclose(losses, r_losses, rtol=1e-10)
    assert set(first) == set(r_first)
    for n in first:
        assert first[n] == pytest.approx(r_first[n], rel=1e-8, abs=1e-12), n
        assert change[n] == pytest.approx(r_change[n], rel=1e-6,
                                          abs=1e-12), n
        np.testing.assert_allclose(params[n].detach().numpy(),
                                   r_after[n].numpy(), rtol=1e-7,
                                   atol=1e-12, err_msg=n)
    ids, pred = program.valid_predictions(tr)
    r_pred, margin = check.reference_valid(ref, cfg, data, ids,
                                           program.state(tr), dev)
    np.testing.assert_allclose(pred, r_pred, rtol=1e-9, atol=1e-12)
    if cfg["family"] == "kgnn":
        assert np.all(margin > 1e-8)
    numbers = check.compare(
        {"losses": losses, "first": first, "change": change, "valid": pred},
        {"losses": r_losses, "first": r_first, "change": r_change,
         "valid": r_pred, "margins": margin}, files.limits("kgnn-train-b1024"))
    assert numbers["loss_gap"] < 1e-10 and numbers["valid_gap"] < 1e-9
    assert numbers["valid_compared"] > 0.5


def test_weights_repeat_from_the_seed_and_follow_their_init():
    cfg = files.config("schnet-6x128")
    specs = files.reference("schnet").param_specs(cfg)
    one = make_weights(specs, 123, "cpu")
    two = make_weights(specs, 123, "cpu")
    other = make_weights(specs, 124, "cpu")
    for name, shape, (kind, scale) in specs:
        assert one[name].shape == shape
        assert torch.equal(one[name], two[name])
        if kind == "uniform":
            assert one[name].abs().max() <= scale
            assert not torch.equal(one[name], other[name])
        if kind == "const":
            assert torch.all(one[name] == scale)


def test_bond_supports_start_equal_across_a_kernels_slots():
    """At the start every ordering of a kernel's supports gives the same
    bond score, so orderings tied on the support score (neighbours with
    equal features) give the same forward whichever one an implementation
    picks."""
    specs = files.reference("kgnn").param_specs(files.config("kgnn-flagship"))
    weights = make_weights(specs, 9, "cpu")
    bonds = [n for n in weights if n.endswith(".edge_attr_support")]
    assert len(bonds) == 16
    for name in bonds:
        w = weights[name]
        assert torch.equal(w, w[:, :1].expand_as(w))
        assert w[:, 0].std() > 0.5
