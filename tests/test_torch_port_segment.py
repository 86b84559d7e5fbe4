"""Port parity: the fixed-order segment sum of ``molkgnn_torch/ops/segment.py``.

The same numpy inputs (from a seed) go through the JAX package's segment
ops (``jax.ops.segment_sum``) and the port's, with plans (the path of the
card: the op over a CSR plan, the autograd Functions) and without (the
CPU's plain version), in fp64 with masks, empty segments and masked terms
in the dump segment (tolerance 1e-12: the same sums, perhaps in another
order); their gradients against ``jax.vjp`` (fp64, 1e-12). The fp32 plain version adds
in list order and must equal ``np.add.at`` bit for bit, the order that the
CUDA kernel keeps (its own check is in ``tests/test_torch_port_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.ops import segment as t_seg
from molkgnn_tpu.ops import segment as j_seg

ROWS, TERMS, SEGMENTS, F = 40, 120, 30, 5


def _x64(fn):
    """Run ``fn`` with jax_enable_x64 on, restoring it afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", False)


def _inputs(seed, masked=0.3):
    """values [ROWS, F], segment ids of TERMS terms over SEGMENTS + 3
    segments (the last three get none: empty), gather rows and a mask."""
    rng = np.random.default_rng(seed)
    return dict(
        values=rng.standard_normal((ROWS, F)),
        ids=rng.integers(0, SEGMENTS, TERMS),
        src=rng.integers(0, ROWS, TERMS),
        mask=rng.random(TERMS) >= masked,
        grad=rng.standard_normal((SEGMENTS + 3, F)),
    )


def _jax_and_port(name, d, planned):
    """(JAX out, JAX d/dvalues, port out, port d/dvalues) of op ``name``
    with output gradient d["grad"], fp64; ``planned``: the port's call is
    given its plans."""
    n = SEGMENTS + 3
    ids, src, mask = (torch.from_numpy(d[k]) for k in ("ids", "src", "mask"))
    plan = t_seg.segment_plan(ids, n, mask) if planned else None
    if name == "segment_sum_nodes":
        vals = np.resize(d["values"], (TERMS, F))  # one row per term
        jfn = lambda v: j_seg.segment_sum_nodes(  # noqa: E731
            v, jnp.asarray(d["ids"]), n, mask=jnp.asarray(d["mask"]))
        tfn = lambda v: t_seg.segment_sum_nodes(  # noqa: E731
            v, ids, n, mask=mask, plan=plan)
    elif name == "gather_scatter_add":
        vals = d["values"]  # ROWS rows gathered into n segments
        plans = ((t_seg.segment_plan(ids, n, mask, gather=src),
                  t_seg.segment_plan(src, ROWS, mask, gather=ids))
                 if planned else None)
        jfn = lambda v: j_seg.gather_scatter_add(  # noqa: E731
            v, jnp.asarray(d["src"]), jnp.asarray(d["ids"]), n,
            edge_mask=jnp.asarray(d["mask"]))
        tfn = lambda v: t_seg.gather_scatter_add(  # noqa: E731
            v, src, ids, n, edge_mask=mask, plans=plans)
    else:  # global_add_pool
        vals = np.resize(d["values"], (TERMS, F))
        jfn = lambda v: j_seg.global_add_pool(  # noqa: E731
            v, jnp.asarray(d["ids"]), n, node_mask=jnp.asarray(d["mask"]))
        tfn = lambda v: t_seg.global_add_pool(  # noqa: E731
            v, ids, n, node_mask=mask, plan=plan)

    def jax_side():
        out, vjp = jax.vjp(jfn, jnp.asarray(vals))
        (dv,) = vjp(jnp.asarray(d["grad"]))
        return np.asarray(out), np.asarray(dv)

    j_out, j_dv = _x64(jax_side)
    v = torch.from_numpy(vals).requires_grad_()
    t_out = tfn(v)
    (t_dv,) = torch.autograd.grad(t_out, v, torch.from_numpy(d["grad"]))
    return j_out, j_dv, t_out.detach().numpy(), t_dv.numpy()


@pytest.mark.parametrize("name", ["segment_sum_nodes", "gather_scatter_add",
                                  "global_add_pool"])
@pytest.mark.parametrize("seed,masked", [(0, 0.0), (1, 0.3), (2, 1.0)])
@pytest.mark.parametrize("planned", [True, False])
def test_segment_ops_and_gradients_match_jax_fp64(name, seed, masked,
                                                  planned):
    """Values and d/dvalues of the three segment ops against the JAX
    package's (``jax.vjp``) in fp64, with plans and without: no mask, some
    terms masked, all masked (every term in the dump segment); the last
    three segments are empty."""
    j_out, j_dv, t_out, t_dv = _jax_and_port(name, _inputs(seed, masked),
                                             planned)
    assert t_out.dtype == np.float64 and t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out, j_out, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_dv, j_dv, rtol=1e-12, atol=1e-12)
    assert not t_out[SEGMENTS:].any()


@pytest.mark.parametrize("planned", [True, False])
@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("rank", [1, 2])
def test_fp32_sums_equal_np_add_at_in_list_order(rank, gathered, planned):
    """fp32 sums with masked terms, with a plan (the op's plain version)
    and without (the CPU's ``index_add_``), equal ``np.add.at`` of the live
    terms in list order bit for bit: -0.0 terms included (a sum from +0
    never stays -0.0), values of rank 1 and 2."""
    d = _inputs(3)
    values = d["values"].astype(np.float32)
    values[::7] = -0.0
    if rank == 1:
        values = np.ascontiguousarray(values[:, 0])
    ids, src, mask = (torch.from_numpy(d[k]) for k in ("ids", "src", "mask"))
    want = np.zeros((SEGMENTS,) + values.shape[1:], np.float32)
    if gathered:
        np.add.at(want, d["ids"][d["mask"]], values[d["src"][d["mask"]]])
        plans = ((t_seg.segment_plan(ids, SEGMENTS, mask, gather=src), None)
                 if planned else None)
        got = t_seg.gather_scatter_add(torch.from_numpy(values), src, ids,
                                       SEGMENTS, edge_mask=mask, plans=plans)
    else:
        terms = np.resize(values, (TERMS,) + values.shape[1:])
        np.add.at(want, d["ids"][d["mask"]], terms[d["mask"]])
        plan = t_seg.segment_plan(ids, SEGMENTS, mask) if planned else None
        got = t_seg.segment_sum_nodes(torch.from_numpy(terms), ids, SEGMENTS,
                                      mask=mask, plan=plan)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_plan_layout():
    """A plan holds each segment's terms in list order, masked terms in the
    dump segment S, and int32 row/rowptr of S + 2 bounds."""
    ids = torch.tensor([2, 0, 2, 1, 0, 2])
    mask = torch.tensor([True, True, False, True, True, True])
    plan = t_seg.segment_plan(ids, 4, mask, gather=torch.arange(6) + 10)
    assert plan.row.dtype == plan.rowptr.dtype == torch.int32
    assert plan.num_segments == 4
    assert plan.rowptr.tolist() == [0, 2, 3, 5, 5, 6]
    assert plan.row.tolist() == [11, 14, 13, 10, 15, 12]
    assert plan.ids.tolist() == [2, 0, 4, 1, 0, 2]


@pytest.mark.parametrize("dim,shape", [(0, (9, 4)), (1, (3, 4, 5)),
                                       (1, (2, 4))])
@pytest.mark.parametrize("planned", [True, False])
def test_take_rows_gradient_matches_jax_fp64(dim, shape, planned):
    """``take_rows`` along ``dim`` at a [P, d] index with repeats (the
    kernel supports at every permutation), and its gradient (with a plan,
    a segment sum over the plan of the index; without, ``index_select``'s)
    against ``jax.vjp`` of ``jnp.take``."""
    rng = np.random.default_rng(4 + dim)
    t = rng.standard_normal(shape)
    idx = rng.integers(0, shape[dim], (6, 3))
    out_shape = shape[:dim] + idx.shape + shape[dim + 1:]
    g = rng.standard_normal(out_shape)

    def jax_side():
        out, vjp = jax.vjp(
            lambda a: jnp.take(a, jnp.asarray(idx), axis=dim), jnp.asarray(t))
        return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])

    j_out, j_dt = _x64(jax_side)
    tt = torch.from_numpy(t).requires_grad_()
    plan = (t_seg.segment_plan(torch.from_numpy(idx), shape[dim])
            if planned else None)
    out = t_seg.take_rows(tt, torch.from_numpy(idx), dim, plan=plan)
    (t_dt,) = torch.autograd.grad(out, tt, torch.from_numpy(g))
    assert tuple(out.shape) == out_shape
    np.testing.assert_array_equal(out.detach().numpy(), j_out)
    np.testing.assert_allclose(t_dt.numpy(), j_dt, rtol=1e-12, atol=1e-12)


def test_export_records_one_segment_sum_node():
    """Under ``torch.export`` (inference) the op is one
    ``molkgnn.segment_sum`` node, traced through its fake implementation,
    and the program computes what the eager op does."""

    class Pool(torch.nn.Module):
        def forward(self, v, ids, mask):
            plan = t_seg.segment_plan(ids, 7, mask)
            return t_seg.global_add_pool(v, ids, 7, node_mask=mask,
                                         plan=plan)

    rng = np.random.default_rng(5)
    args = (torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 7, 20)),
            torch.from_numpy(rng.random(20) > 0.2))
    with torch.no_grad():
        program = torch.export.export(Pool(), args)
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and "segment_sum" in str(n.target)]
    assert [str(n.target) for n in nodes] == ["molkgnn.segment_sum.default"]
    assert torch.equal(program.module()(*args), Pool()(*args))


def _flagship_step(batch, model, weights):
    """The flagship's predictions, embeddings and every gradient of one
    train-mode forward and backward under fixed output weights."""
    pred, emb = model(batch)
    loss = (pred * weights[0]).sum() + (emb * weights[1]).sum()
    loss.backward()
    return [pred.detach(), emb.detach()] + [
        p.grad for _, p in sorted(model.named_parameters())
        if p.grad is not None]


@pytest.mark.parametrize("dtype,use_kernel", [
    (torch.float32, True), (torch.float32, False), (torch.float64, True)])
def test_flagship_on_plans_bit_equal_to_plain(monkeypatch, dtype,
                                              use_kernel):
    """The card's path on the CPU: the flagship's forward and backward with
    ``planned`` forced, so that every sum goes through plans (those that
    MolGCN and MolKGNNNet build, the bucket plans without padded rows, the
    perms plans, the plans a backward builds from its nonzero rows, the
    op's CPU body), against the plain CPU run from the same weights, on
    molecules with argmax ties: bit-equal."""
    import copy
    import dataclasses

    from molkgnn_torch.data.synthetic import random_dataset
    from molkgnn_torch.graphs.batch import batch_graphs, spec_for_graphs
    from molkgnn_torch.models import kgnn
    from molkgnn_torch.training.model import GNNModel

    graphs = random_dataset(seed=3, num_graphs=6)
    batch = batch_graphs(graphs, spec_for_graphs(graphs, batch_size=6))
    if dtype == torch.float64:
        cast = lambda t: t.double() if t.is_floating_point() else t  # noqa
        batch = dataclasses.replace(
            batch, x=cast(batch.x), p=cast(batch.p),
            edge_attr=cast(batch.edge_attr), **{
                f"deg{d}": dataclasses.replace(
                    b, nei_edge_attr=cast(b.nei_edge_attr))
                for d, b in enumerate(batch.buckets(), start=1)})
    gen = torch.Generator().manual_seed(0)
    model = GNNModel(kgnn.MolKGNNNet(
        num_layers=2, kernels_1hop=(2, 3, 3, 4), kernels_nhop=(2, 3, 3, 4),
        graph_embedding_dim=8, use_kernel=use_kernel, generator=gen),
        generator=gen, ffn_dropout_rate=0.0).to(dtype).train()
    weights = [torch.randn(6, generator=gen, dtype=dtype),
               torch.randn(6, 8, generator=gen, dtype=dtype)]
    calls = []
    plain = t_seg.segment_sum_plain
    monkeypatch.setattr(t_seg, "segment_sum_plain",
                        lambda *a: calls.append(1) or plain(*a))
    want = _flagship_step(batch, copy.deepcopy(model), weights)
    assert not calls  # the plain CPU run builds no plan
    monkeypatch.setattr(t_seg, "planned", lambda t: True)
    monkeypatch.setattr(kgnn, "planned", lambda t: True)
    got = _flagship_step(batch, copy.deepcopy(model), weights)
    assert len(calls) > 10
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


def _lsd_order(keys, passes, tile):
    """The plan kernel's sort written out in numpy: ``passes`` 8-bit LSD
    passes, each counting the digits of every tile of ``tile`` keys,
    scanning the counts in [digit][tile] order and placing each key at its
    digit's offset in its tile plus the keys of that digit before it in
    the tile, in list order."""
    order = np.arange(len(keys))
    keys = keys.copy()
    tiles = -(-len(keys) // tile)
    for p in range(passes):
        digit = (keys >> (8 * p)) & 255
        counts = np.zeros((256, tiles), np.int64)
        for t in range(tiles):
            counts[:, t] = np.bincount(digit[t * tile:(t + 1) * tile],
                                       minlength=256)
        running = (np.cumsum(counts.ravel()) - counts.ravel()).reshape(
            counts.shape)
        pos = np.empty(len(keys), np.int64)
        for i, d in enumerate(digit):
            pos[i] = running[d, i // tile]
            running[d, i // tile] += 1
        new_keys, new_order = np.empty_like(keys), np.empty_like(order)
        new_keys[pos], new_order[pos] = keys, order
        keys, order = new_keys, new_order
    return order


@pytest.mark.parametrize("segments,passes", [
    (0, 1), (1, 1), (255, 1), (256, 2), (65_535, 2), (65_536, 3),
    (2**24 - 1, 3), (2**24, 4)])
def test_plan_pass_schedule_gives_the_stable_sort(segments, passes):
    """The plan kernel's digit passes: keys lie in [0, S] (S the dump
    segment), so S.bit_length() bits, 8 a pass. The kernel's passes,
    emulated over tiles of ``PLAN_TILE`` keys, give ``torch.sort(stable=
    True)``'s order on keys that reach S, and so the plain plan's row and
    rowptr; one pass fewer does not (where there are fewer than 4)."""
    assert t_seg.plan_passes(segments) == passes
    if segments > 65_536:
        return  # the schedule alone: the emulation stays small
    rng = np.random.default_rng(segments)
    terms = 2 * t_seg.PLAN_TILE + 77  # three tiles, the last ragged
    ids = rng.integers(0, max(segments, 1), terms)
    mask = rng.random(terms) >= 0.25
    gather = rng.integers(0, 500, terms)
    keys = np.where(mask, ids, segments)
    want = torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()
    order = _lsd_order(keys, passes, t_seg.PLAN_TILE)
    assert np.array_equal(order, want)
    if passes > 1:
        assert not np.array_equal(
            _lsd_order(keys, passes - 1, t_seg.PLAN_TILE), want)
    plan = t_seg.segment_plan_plain(torch.from_numpy(ids), segments,
                                    torch.from_numpy(mask),
                                    torch.from_numpy(gather))
    assert np.array_equal(plan.row.numpy(), gather[order])
    bounds = np.searchsorted(keys[order], np.arange(segments + 2))
    assert np.array_equal(plan.rowptr.numpy(), bounds)
    assert np.array_equal(plan.ids.numpy(), keys)
    assert t_seg.plan_scratch(terms, segments) == (
        4 * terms + 256 * 3 + 256 + -(-(segments + 2) // t_seg.PLAN_CHUNK))


@pytest.mark.parametrize("item,f,segments,rows,align,want", [
    # message passing and its gradients at width 110: float2 / double2, two
    # a lane
    (4, 110, 42_312, 42_312, 256, (2, 32, 2, 1, False)),
    (8, 110, 42_312, 42_312, 256, (2, 32, 2, 1, False)),
    # pooling at 32: 1024 segments of float4 lanes would be 256 warps, too
    # few for the card, so scalar lanes, a warp a segment
    (4, 32, 1024, 42_312, 256, (1, 32, 1, 1, False)),
    # at 32 with many segments: four segments a warp of float4 lanes, and
    # narrower vectors from a values view 8 or 4 bytes off 16
    (4, 32, 42_312, 42_312, 256, (4, 8, 1, 1, False)),
    (4, 32, 42_312, 42_312, 8, (2, 16, 1, 1, False)),
    (4, 32, 42_312, 42_312, 4, (1, 32, 1, 1, False)),
    (8, 32, 42_312, 42_312, 8, (1, 32, 1, 1, False)),
    # the [N] sums and narrow rows
    (4, 1, 42_312, 85_336, 256, (1, 1, 1, 1, False)),
    (8, 3, 500, 900, 256, (1, 4, 1, 1, False)),
    (4, 128, 42_312, 42_312, 256, (4, 32, 1, 1, False)),
    # the perms gradient: 4 segments, 5500 wide, in 172 tiles
    (4, 5500, 4, 48, 256, (1, 32, 1, 172, False)),
    (4, 5500, 42_312, 48, 256, (4, 32, 4, 11, False)),
    # past 32-bit indices
    (4, 110, 4, 2**31 // 110 + 1, 256, (1, 32, 1, 4, True)),
])
def test_sum_launch_shapes(item, f, segments, rows, align, want):
    """The segment-sum kernel's launch shape (csrc/segment_sum.cu's note):
    the widest vector the row and the pointers allow unless its warps are
    too few for the card, lanes for the row's vectors up to 32, more
    vectors a lane only where the segments fill the card, 64-bit indices
    past an int32; the tiles cover the row."""
    got = t_seg.sum_launch(item, f, segments, rows, align)
    assert tuple(got) == want
    assert f % got.vec == 0 and got.vec * item <= 16
    assert got.tiles * got.group * got.cpl >= f // got.vec
