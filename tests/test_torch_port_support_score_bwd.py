"""Port parity: the permutation-max support scorer's backward.

The port's backward goes through one registered op,
``torch.ops.molkgnn.support_score_backward``; on the CPU its body is the
plain version (``support_score_backward_plain``). It is held against
``jax.vjp`` of the JAX package's Pallas scorers (interpret mode) in fp64,
within 1e-10: the JAX backward asks its products for float32
(``preferred_element_type``), so the JAX module runs here through a
stand-in for its ``jnp`` whose float32 is float64, and the reference is
float64 throughout. The operands are random normals with no near tie in
the argmax (checked), so both sides pick the same permutations. The CUDA
kernels are held against the plain version in
``tests/test_torch_port_cuda.py``, which runs only where a card is present.
"""

import functools
import re
import types
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from molkgnn_torch.ops import support_score as ss
from molkgnn_torch.tools.backward_profile import tf32_work
from molkgnn_tpu.ops import pallas_kernels as pk

TOL = 1e-10

# (M, K = d * F, L, P) of the flagship's four degree groups at F = 3.
FLAGSHIP_NARROW = [(13, 3, 4, 1), (11, 6, 5, 2), (9, 9, 6, 6), (7, 12, 7, 12)]


@pytest.fixture
def jax64(monkeypatch):
    """JAX in float64, with the Pallas module's float32 products in
    float64 (see the module doc)."""
    stand_in = types.SimpleNamespace(
        **{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    stand_in.float32 = jnp.float64
    monkeypatch.setattr(pk, "jnp", stand_in)
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _assert_tie_free(a, b):
    """At least 1e-6 between the top two scores of every (m, l), so that no
    argmax rests on rounding."""
    sc = np.einsum("mk,pkl->mlp", a, b)
    if sc.shape[2] > 1:
        top2 = -np.sort(-sc, axis=2)[..., :2]
        assert (top2[..., 0] - top2[..., 1]).min() > 1e-6


def _operands(rng, shapes):
    """fp64 a [M, K] and b [P, K, L], tie-free."""
    a = [rng.standard_normal((m, k)) for m, k, _, _ in shapes]
    b = [rng.standard_normal((p, k, l)) for _, k, l, p in shapes]
    for x, y in zip(a, b):
        _assert_tie_free(x, y)
    return a, b


def _port_grads(a_np, b_np, g_np, a_of, b_grad):
    """Gradients of sum_i <best_i, g_i> through the port's grouped scorer
    (its Function, whose backward is the registered op). ``a_of[i]``: the
    distinct a that group i scores; ``b_grad[i]``: whether b_i takes a
    gradient. Returns (da per distinct a, db per group or None, argmaxes)."""
    ta = [torch.from_numpy(x).requires_grad_() for x in a_np]
    tb = [torch.from_numpy(y).requires_grad_(bool(w))
          for y, w in zip(b_np, b_grad)]
    outs = ss.grouped_support_score([ta[i] for i in a_of], tb)
    loss = sum((best * torch.from_numpy(g)).sum()
               for (best, _), g in zip(outs, g_np))
    loss.backward()
    return ([t.grad.numpy() for t in ta],
            [t.grad.numpy() if t.requires_grad else None for t in tb],
            [idx.numpy() for _, idx in outs])


@functools.partial(jax.jit, static_argnums=3)
def _jax_vjp(a_list, b_list, g_list, a_of):
    """(da per distinct a, db per group, argmaxes) by jax.vjp of the JAX
    package's grouped scorer; jitted, which compiles the interpreted
    kernel and its VJP once (eager dispatch compiles each op alone)."""

    def bests(a_list, b_list):
        outs = pk.grouped_support_score(
            [a_list[i] for i in a_of], b_list, interpret=True)
        return [best for best, _ in outs], [idx for _, idx in outs]

    out, vjp, idxs = jax.vjp(bests, a_list, b_list, has_aux=True)
    return (*vjp(g_list), idxs, [x.dtype == jnp.float64 for x in out])


def _jax_grads(a_np, b_np, g_np, a_of):
    """The same through jax.vjp of the JAX package's grouped scorer."""
    da, db, idxs, fp64 = _jax_vjp([jnp.asarray(x) for x in a_np],
                                  [jnp.asarray(y) for y in b_np],
                                  [jnp.asarray(g) for g in g_np], tuple(a_of))
    assert all(fp64)
    return ([np.asarray(x) for x in da], [np.asarray(y) for y in db],
            [np.asarray(i) for i in idxs])


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _compare(rng, a_np, b_np, a_of, b_grad):
    """Port against JAX on one grouped call: argmaxes equal, every a's and
    every trainable b's gradient within TOL."""
    g_np = [rng.standard_normal((a_np[i].shape[0], y.shape[2]))
            for i, y in zip(a_of, b_np)]
    got_a, got_b, got_idx = _port_grads(a_np, b_np, g_np, a_of, b_grad)
    want_a, want_b, want_idx = _jax_grads(a_np, b_np, g_np, a_of)
    for got, want in zip(got_idx, want_idx):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(got_a, want_a):
        _assert_close(got, want)
    for got, want, w in zip(got_b, want_b, b_grad):
        if w:
            _assert_close(got, want)
        else:
            assert got is None


def test_flagship_groups_match_jax_vjp(jax64):
    """Four flagship-like degree groups in one grouped call."""
    rng = np.random.default_rng(0)
    a_np, b_np = _operands(rng, FLAGSHIP_NARROW)
    _compare(rng, a_np, b_np, [0, 1, 2, 3], [True] * 4)


def test_fixed_set_layout_matches_jax_vjp(jax64):
    """A fixed-set layer 0: each degree's fixed and trainable sets (8
    groups) share the degree's a; the fixed sets' b take no gradient, and
    each a's gradient is the sum over its two groups."""
    rng = np.random.default_rng(1)
    a_np = [rng.standard_normal((m, k)) for m, k, _, _ in FLAGSHIP_NARROW]
    b_np = [rng.standard_normal((p, k, l))
            for _, k, l0, p in FLAGSHIP_NARROW for l in (l0 - 2, l0)]
    a_of = [i // 2 for i in range(8)]
    for i, y in zip(a_of, b_np):
        _assert_tie_free(a_np[i], y)
    _compare(rng, a_np, b_np, a_of, [i % 2 == 1 for i in range(8)])


def test_b_without_gradient_matches_jax_vjp(jax64):
    """Only the a's take a gradient; the op is asked for no db."""
    rng = np.random.default_rng(2)
    a_np, b_np = _operands(rng, FLAGSHIP_NARROW)
    _compare(rng, a_np, b_np, [0, 1, 2, 3], [False] * 4)


def test_single_group_matches_jax_fused_vjp(jax64):
    """G = 1, the fused scorer, against jax.vjp of the JAX fused scorer."""
    rng = np.random.default_rng(3)
    (a,), (b,) = _operands(rng, [(10, 24, 6, 12)])
    g = rng.standard_normal((10, 6))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    best, _ = ss.fused_support_score(ta, tb)
    (best * torch.from_numpy(g)).sum().backward()

    @jax.jit
    def jax_vjp(x, y, g):
        (best, _), vjp = jax.vjp(
            lambda x, y: pk.fused_support_score(x, y, interpret=True), x, y)
        return best.dtype == jnp.float64, *vjp(
            (g, np.zeros(g.shape, jax.dtypes.float0)))

    fp64, da, db = jax_vjp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(g))
    assert fp64
    _assert_close(ta.grad.numpy(), np.asarray(da))
    _assert_close(tb.grad.numpy(), np.asarray(db))


def test_registered_op_matches_plain_version():
    """The op's CPU body, called directly, lays each group's plain da and
    db back to back at ``backward_offsets``, and leaves out what is not
    needed."""
    rng = np.random.default_rng(4)
    a_np, b_np = _operands(rng, FLAGSHIP_NARROW)
    a = [torch.from_numpy(x) for x in a_np]
    b = [torch.from_numpy(y) for y in b_np]
    g = [torch.from_numpy(rng.standard_normal((m, l)))
         for m, _, l, _ in FLAGSHIP_NARROW]
    idx = [ss.support_score_plain(x, y)[1] for x, y in zip(a, b)]
    need_a, need_b = [True, False, True, True], [True, True, False, True]
    da, db = torch.ops.molkgnn.support_score_backward(a, b, g, idx, need_a,
                                                      need_b)
    da_off, n_da, db_off, n_db = ss.backward_offsets(FLAGSHIP_NARROW, need_a,
                                                     need_b)
    assert da.shape == (n_da,) and db.shape == (n_db,)
    for i, (m, k, l, p) in enumerate(FLAGSHIP_NARROW):
        want_a, want_b = ss.support_score_backward_plain(
            a[i], b[i], g[i], idx[i], need_a[i], need_b[i])
        if need_a[i]:
            assert torch.equal(da[da_off[i]:da_off[i] + m * k].view(m, k),
                               want_a)
        if need_b[i]:
            assert torch.equal(
                db[db_off[i]:db_off[i] + p * k * l].view(p, k, l), want_b)


@pytest.mark.parametrize(
    "need_a,need_b,want",
    [
        ([True, True], [True, True], ([0, 6], 14, [0, 24], 48)),
        ([False, True], [True, False], ([0, 0], 8, [0, 24], 24)),
        ([True, False], [False, False], ([0, 6], 6, [0, 0], 0)),
    ],
)
def test_backward_offsets(need_a, need_b, want):
    """Groups (M, K, L, P) = (3, 2, 4, 3) and (4, 2, 3, 4): a gradient that
    is not needed takes no room in its flat buffer."""
    assert ss.backward_offsets([(3, 2, 4, 3), (4, 2, 3, 4)], need_a,
                               need_b) == want


def test_cpu_tensors_never_launch_the_backward():
    before = ss.support_score_backward.launches
    a = torch.randn(5, 6, requires_grad=True)
    b = torch.randn(2, 6, 3, requires_grad=True)
    (best, _), = ss.grouped_support_score([a], [b])
    best.sum().backward()
    best, _ = ss.fused_support_score(a, b)
    best.sum().backward()
    assert a.grad is not None and b.grad is not None
    assert ss.support_score_backward.launches == before


def test_backward_fake_gives_the_shapes():
    """Under fake tensors (``torch.export``, the compiler's tracing) the op
    returns flat buffers of the lengths ``backward_offsets`` gives."""
    with FakeTensorMode():
        a = [torch.empty(7, 12), torch.empty(5, 6)]
        b = [torch.empty(12, 12, 7), torch.empty(2, 6, 5)]
        g = [torch.empty(7, 7), torch.empty(5, 5)]
        idx = [torch.empty(7, 7, dtype=torch.int32),
               torch.empty(5, 5, dtype=torch.int32)]
        da, db = torch.ops.molkgnn.support_score_backward(
            a, b, g, idx, [True, False], [True, True])
        assert da.shape == (7 * 12,) and db.shape == (12 * 12 * 7 + 60,)
        assert da.dtype == db.dtype == torch.float32


# The CUDA kernels' arithmetic (3xTF32), emulated on the CPU by
# ``support_score_backward_3xtf32``; the card tests' limit for each
# gradient is 1e-5 * max(1, max |reference|).
CARD_LIMIT = 1e-5


def _card_error(got, want):
    """Largest difference over 1e-5 * max(1, max |want|)."""
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, np.abs(want).max())
    return np.abs(np.asarray(got, dtype=np.float64) - want).max() / scale


@pytest.mark.parametrize(
    "x,want",
    [
        (1.0, 1.0),
        (1 + 2**-11, 1 + 2**-10),  # a tie: away from zero
        (-(1 + 2**-11), -(1 + 2**-10)),
        (1 + 2**-12, 1.0),
        (1 + 3 * 2**-12, 1 + 2**-10),
        (1 + 2**-10 + 2**-11, 1 + 2**-9),  # a tie on an odd last bit
        (0.0, 0.0),
    ],
)
def test_tf32_round_is_nearest_ties_away(x, want):
    """``tf32_round`` keeps 10 mantissa bits, to nearest, ties away from
    zero (``cvt.rna.tf32.f32``)."""
    got = ss.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


def test_split_tf32_parts():
    """hi and lo are TF32 values (13 low bits 0) and hi + lo stands within
    2^-21 of x."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         ).float()
    hi, lo = ss.split_tf32(x)
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0**-21 * x.double().abs()).all()


def test_3xtf32_matches_jax_vjp_on_flagship_groups(jax64):
    """On the narrow flagship groups the kernels' arithmetic (fp32 operands
    split into TF32 parts, three products) stands within the card tests'
    limit of the fp64 ``jax.vjp`` of the JAX grouped scorer, each
    gradient."""
    rng = np.random.default_rng(6)
    a_np, b_np = _operands(rng, FLAGSHIP_NARROW)
    g_np = [rng.standard_normal((x.shape[0], y.shape[2]))
            for x, y in zip(a_np, b_np)]
    want_a, want_b, idxs = _jax_grads(a_np, b_np, g_np, [0, 1, 2, 3])
    for i in range(len(FLAGSHIP_NARROW)):
        da, db = ss.support_score_backward_3xtf32(
            torch.from_numpy(a_np[i]), torch.from_numpy(b_np[i]),
            torch.from_numpy(g_np[i]), torch.from_numpy(np.array(idxs[i])))
        assert da.dtype == db.dtype == torch.float32
        assert _card_error(da.numpy(), want_a[i]) <= CARD_LIMIT
        assert _card_error(db.numpy(), want_b[i]) <= CARD_LIMIT


def test_3xtf32_holds_the_card_limit_where_tf32_does_not():
    """A full-width N-hop degree-4 group (K = 440, L = 50, P = 12) with M
    cut to 300 rows, operands as on the model's path (unit rows of a, unit
    columns of b along k): the three products stand within 1e-5 * max(1,
    max |fp64|) of the fp64 gradients; hi*hi alone (plain TF32) does not,
    for either gradient. The emulation sums in IEEE fp32, so this checks
    the split alone; the tensor cores' own sums, which round toward zero at
    each accumulation, are held against fp64 on the card
    (``test_cuda_backward_kernels_as_accurate_as_fp32``)."""
    rng = np.random.default_rng(7)
    m, k, l, p = 300, 440, 50, 12
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((p, l, k))
    a = torch.from_numpy(a / np.linalg.norm(a, axis=1, keepdims=True))
    b = torch.from_numpy(
        (b / np.linalg.norm(b, axis=2, keepdims=True)).transpose(0, 2, 1)
        .copy())
    g = torch.from_numpy(rng.standard_normal((m, l)))
    idx = torch.from_numpy(rng.integers(0, p, (m, l), dtype=np.int32))
    exact = ss.support_score_backward_plain(a, b, g, idx)
    split = ss.support_score_backward_3xtf32(a, b, g, idx)
    tf32 = ss.support_score_backward_3xtf32(a, b, g, idx, terms=1)
    for got, plain, want in zip(split, tf32, exact):
        assert _card_error(got.numpy(), want.numpy()) <= CARD_LIMIT
        assert _card_error(plain.numpy(), want.numpy()) > CARD_LIMIT


def test_3xtf32_leaves_out_what_is_not_needed():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((5, 6))).float()
    b = torch.from_numpy(rng.standard_normal((2, 6, 3))).float()
    g = torch.from_numpy(rng.standard_normal((5, 3))).float()
    idx = torch.from_numpy(rng.integers(0, 2, (5, 3), dtype=np.int32))
    da, db = ss.support_score_backward_3xtf32(a, b, g, idx, need_b=False)
    assert da.shape == (5, 6) and db is None
    da, db = ss.support_score_backward_3xtf32(a, b, g, idx, need_a=False)
    assert da is None and db.shape == (2, 6, 3)


@pytest.mark.parametrize(
    "shape,need_a,need_b,want",
    [
        # da: 64 x 32 x 32 of M, K, N; db: 64 x 32 x 32 of K, N, M.
        ((64, 32, 8, 1), True, False, 6 * 64 * 32 * 32),
        ((64, 32, 8, 1), False, True, 6 * 64 * 32 * 64),
        ((65, 28, 10, 1), True, True,
         6 * (128 * 32 * 32 + 64 * 32 * 96)),
        ((0, 28, 10, 1), True, True, 0),
    ],
)
def test_backward_mma_flops(shape, need_a, need_b, want):
    """The TF32 operations the kernels issue: the one-hot products padded
    to the kernels' tiles, three of them, 2 operations a multiply-add
    (``tools/backward_profile.py``'s count, which phase 5 prints too)."""
    work = tf32_work([shape], [need_a], [need_b], device_ms=2.0)
    assert work["flops"] == want
    assert work["ms"] == pytest.approx(want / 495e9)
    assert work["share"] == pytest.approx(work["ms"] / 2.0)


# The tensor cores' rounding, emulated on the CPU by
# ``support_score_backward_emulated``: every accumulation into a wgmma
# accumulator rounds toward zero, and the kernels add the accumulator into
# an fp32 sum rounded to nearest every few k8 steps (promotion).
_BWD_SOURCE = (Path(ss.__file__).resolve().parent.parent / "csrc"
               / "support_score_bwd.cu")


def _source_constant(name):
    """The value of ``constexpr int name = value;`` in the kernels' source."""
    found = re.findall(rf"constexpr int {name} = (\d+);",
                       _BWD_SOURCE.read_text())
    assert len(found) == 1, name
    return int(found[0])


def test_emulated_intervals_are_the_kernels():
    """The emulation's promotion intervals are the kernels' own: da every
    kDaPromoteSteps k8 steps, db every kDbPromoteChunks chunks of kDbRows
    rows (8 rows a step)."""
    assert ss.DA_PROMOTE_STEPS == _source_constant("kDaPromoteSteps")
    assert ss.DB_PROMOTE_STEPS == (_source_constant("kDbPromoteChunks")
                                   * _source_constant("kDbRows") // 8)


@pytest.mark.parametrize(
    "x,zero,nearest",
    [
        (1 + 2.0**-30, 1.0, 1.0),
        (1 - 2.0**-30, 1 - 2.0**-24, 1.0),
        (-(1 - 2.0**-30), -(1 - 2.0**-24), -1.0),
        (1 + 3 * 2.0**-25, 1.0, 1 + 2.0**-23),
        (0.0, 0.0, 0.0),
    ],
)
def test_round_fp32_toward_zero_and_to_nearest(x, zero, nearest):
    """fp64 to fp32: toward zero (the tensor cores' accumulation) and to
    nearest (an IEEE fp32 add)."""
    t = torch.tensor([x], dtype=torch.float64)
    assert ss._round_fp32(t, True).item() == zero
    assert ss._round_fp32(t, False).item() == nearest


def _toward_zero(x: Fraction) -> np.float32:
    """The fp32 value nearest x in the direction of zero, exactly."""
    c = np.float32(float(x))
    if abs(Fraction(float(c))) > abs(x):
        c = np.nextafter(c, np.float32(0))
    return c


def _literal_chain(steps, promote):
    """One output's sum as the kernels take it, element by element in exact
    arithmetic: ``steps`` lists each k8 step's three products as lists of
    (x, y) pairs; each product's exact sum is added into the accumulator,
    rounded toward zero; every ``promote`` steps (None: at the end) the
    accumulator goes into an fp32 sum rounded to nearest."""
    total, acc = np.float32(0), None
    for t, products in enumerate(steps):
        if promote is not None and t % promote == 0 and acc is not None:
            total, acc = np.float32(total + acc), None
        for pairs in products:
            exact = sum((Fraction(float(x)) * Fraction(float(y))
                         for x, y in pairs), Fraction(0))
            acc = _toward_zero(exact + Fraction(float(acc or 0)))
    return np.float32(total + acc) if acc is not None else total


def _literal_backward(a, b, g, idx, promote, db_rows):
    """``support_score_backward_emulated`` written out one output element
    at a time (numpy, exact fractions), for small shapes."""
    m, k = a.shape
    p, _, l = b.shape
    s = np.zeros((m, p, l), np.float32)
    for i in range(m):
        for j in range(l):
            s[i, idx[i, j], j] = g[i, j]
    a_hi, a_lo = (x.numpy() for x in ss.split_tf32(torch.from_numpy(a)))
    b_hi, b_lo = (x.numpy() for x in ss.split_tf32(torch.from_numpy(b)))
    s_hi, s_lo = (x.numpy() for x in ss.split_tf32(torch.from_numpy(s)))
    order = [(n % p, n // p) for n in range(p * l)]  # n' = l P + p
    da = np.zeros((m, k), np.float32)
    for i in range(m):
        for c in range(k):
            steps = []
            for n0 in range(0, p * l, 8):
                cols = order[n0:n0 + 8]
                steps.append([
                    [(s_lo[i, q, j], b_hi[q, c, j]) for q, j in cols],
                    [(s_hi[i, q, j], b_lo[q, c, j]) for q, j in cols],
                    [(s_hi[i, q, j], b_hi[q, c, j]) for q, j in cols]])
            da[i, c] = _literal_chain(steps, promote)
    db = np.zeros((p, k, l), np.float32)
    starts = range(0, m, db_rows)
    for q in range(p):
        for c in range(k):
            for j in range(l):
                parts = []
                for r0 in starts:
                    rows = range(r0, min(m, r0 + db_rows))
                    steps = []
                    for m0 in range(r0, r0 + db_rows, 8):
                        rr = [r for r in range(m0, m0 + 8) if r in rows]
                        steps.append([
                            [(a_lo[r, c], s_hi[r, q, j]) for r in rr],
                            [(a_hi[r, c], s_lo[r, q, j]) for r in rr],
                            [(a_hi[r, c], s_hi[r, q, j]) for r in rr]])
                    parts.append(_literal_chain(steps, promote))
                sums = [np.float32(0)] * 8
                for r, part in enumerate(parts):
                    sums[r % 8] = np.float32(sums[r % 8] + part)
                db[q, c, j] = ((sums[0] + sums[1]) + (sums[2] + sums[3])) + (
                    (sums[4] + sums[5]) + (sums[6] + sums[7]))
    return da, db


@pytest.mark.parametrize("promote", [None, 1, 2])
def test_emulation_matches_a_literal_loop(promote):
    """The vectorised emulation, bit for bit, against the same arithmetic
    written out one output element at a time in exact fractions: 37 rows in
    ranges of 16 (3 ranges, the last ragged), P = 6 and L = 3 (3 steps of
    n'), with the accumulator promoted every step, every 2 steps, or at the
    end only (the order before promotion)."""
    rng = np.random.default_rng(21)
    m, k, l, p = 37, 5, 3, 6
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((p, k, l)).astype(np.float32)
    g = rng.standard_normal((m, l)).astype(np.float32)
    idx = rng.integers(0, p, (m, l), dtype=np.int32)
    da, db = ss.support_score_backward_emulated(
        *(torch.from_numpy(x) for x in (a, b, g, idx)),
        da_promote=promote, db_promote=promote, db_rows=16)
    want_a, want_b = _literal_backward(a, b, g, idx, promote, 16)
    assert da.dtype == db.dtype == torch.float32
    np.testing.assert_array_equal(da.numpy(), want_a)
    np.testing.assert_array_equal(db.numpy(), want_b)


def _unit_group(seed, shape):
    """fp32 a and b unit vectors along k, g standard normal, idx uniform in
    [0, P), as the card tests draw them."""
    rng = np.random.default_rng(seed)
    m, k, l, p = shape
    a = rng.standard_normal((m, k))
    b = rng.standard_normal((p, l, k))
    a = a / np.linalg.norm(a, axis=1, keepdims=True)
    b = (b / np.linalg.norm(b, axis=2, keepdims=True)).transpose(0, 2, 1)
    g = rng.standard_normal((m, l))
    idx = rng.integers(0, p, (m, l), dtype=np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).float()
                 if x.dtype != np.int32 else torch.from_numpy(x)
                 for x in (a, b, g, idx))


# (group, gradient): the flagship N-hop layer's degree-4 group with M cut
# to 1000, and the P = 1 groups of layer 0 and of an N-hop layer at full
# size; db in ranges of 32 kDbRangeChunks P rows.
PROMOTION_CASES = {
    "degree 4, da": ((1000, 440, 50, 12), "da"),
    "degree 4, db": ((1000, 440, 50, 12), "db"),
    "layer 0, P = 1, db": ((19232, 28, 10, 1), "db"),
    "N-hop, P = 1, db": ((19232, 110, 10, 1), "db"),
}


@functools.lru_cache(maxsize=None)
def _distances(case, toward_zero=True):
    """max |x - x64| of one gradient: promoted at the kernels' intervals,
    unpromoted, and the fp32 einsum (the plain route in fp32); x64 the
    plain route in fp64."""
    shape, what = PROMOTION_CASES[case]
    a, b, g, idx = _unit_group(22, shape)
    want = 0 if what == "da" else 1
    need = dict(need_a=what == "da", need_b=what == "db")
    exact = ss.support_score_backward_plain(
        a.double(), b.double(), g.double(), idx, **need)[want]
    rows = 32 * _source_constant("kDbRangeChunks") * shape[3]

    def dist(x):
        return (x.double() - exact).abs().max().item()

    promoted = ss.support_score_backward_emulated(
        a, b, g, idx, db_rows=rows, toward_zero=toward_zero, **need)[want]
    unpromoted = ss.support_score_backward_emulated(
        a, b, g, idx, da_promote=None, db_promote=None, db_rows=rows,
        toward_zero=toward_zero, **need)[want]
    fp32 = ss.support_score_backward_plain(a, b, g, idx, **need)[want]
    return dist(promoted), dist(unpromoted), dist(fp32)


@pytest.mark.parametrize("case", ["degree 4, da", "degree 4, db",
                                  "layer 0, P = 1, db"])
def test_promotion_brings_the_kernels_order_toward_fp64(case):
    """With the tensor cores' rounding toward zero, the kernels' promoted
    order stands at least 3x closer to fp64 than the unpromoted order,
    whose chains of accumulations grow with P * L (da) and with the
    rows of a range (db). (At the N-hop layer's P = 1 the promoted db is
    about as far as the fp32 einsum, which the test below holds, and the
    unpromoted one about 3x farther.)"""
    promoted, unpromoted, _ = _distances(case)
    assert 3 * promoted <= unpromoted, (promoted, unpromoted)


@pytest.mark.parametrize("case", sorted(PROMOTION_CASES))
def test_promoted_order_within_3x_of_fp32(case):
    """The kernels' promoted order stands within 3x of the fp32 einsum's
    distance from fp64."""
    promoted, _, fp32 = _distances(case)
    assert promoted <= 3 * fp32, (promoted, fp32)


def test_rounding_to_nearest_would_need_no_promotion():
    """The cause, isolated: had the accumulator rounded to nearest, the
    unpromoted order would stand at least 3x closer to fp64 than it does
    rounding toward zero (degree 4's db, ranges of 1,000 rows)."""
    _, nearest, _ = _distances("degree 4, db", toward_zero=False)
    _, toward_zero, _ = _distances("degree 4, db")
    assert 3 * nearest <= toward_zero, (nearest, toward_zero)


def test_interval_past_the_chain_is_the_unpromoted_order():
    """A promotion interval at least the chain's length gives the unpromoted
    order bit for bit: da's 75 steps (P = 12, L = 50) and db's ranges of 25
    steps; at layer 0's P = 1, L = 10, da's two steps are never promoted at
    the kernels' interval either."""
    a, b, g, idx = _unit_group(23, (200, 44, 50, 12))
    long = ss.support_score_backward_emulated(a, b, g, idx, da_promote=75,
                                              db_promote=25)
    none = ss.support_score_backward_emulated(a, b, g, idx, da_promote=None,
                                              db_promote=None)
    for x, y in zip(long, none):
        assert torch.equal(x, y)
    a, b, g, idx = _unit_group(24, (300, 28, 10, 1))
    kernels = ss.support_score_backward_emulated(a, b, g, idx, need_b=False)
    none = ss.support_score_backward_emulated(a, b, g, idx, need_b=False,
                                              da_promote=None)
    assert torch.equal(kernels[0], none[0])
