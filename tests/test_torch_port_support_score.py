"""Port parity: the permutation-max support scorer.

On the CPU the wrappers take the plain PyTorch version; it is held against
the JAX Pallas kernels run in interpret mode on every case of
``tests/test_pallas.py`` (best within 1e-5, as there; argmax equal, since
the random inputs have no near ties; exact ties go to the first
permutation). The CUDA kernel itself is held against the plain version in
``tests/test_torch_port_cuda.py``, which runs only where a card is present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molkgnn_torch.ops import support_score as ss
from molkgnn_tpu.ops.pallas_kernels import (
    fused_support_score as j_fused,
    grouped_support_score as j_grouped,
)

FUSED_SHAPES = [(37, 112, 50, 12), (8, 28, 3, 2), (200, 440, 30, 6)]
GROUPED_SHAPES = [
    (37, 28, 10, 1), (61, 56, 20, 2), (23, 84, 30, 6), (49, 112, 50, 12),
]


def _operands(rng, shapes):
    a = [rng.standard_normal((m, k)).astype(np.float32) for m, k, _, _ in shapes]
    b = [
        rng.standard_normal((p, k, l)).astype(np.float32)
        for _, k, l, p in shapes
    ]
    return a, b


@pytest.mark.parametrize("m,k,l,p", FUSED_SHAPES)
def test_fused_plain_matches_jax_kernel(m, k, l, p):
    rng = np.random.default_rng(m)
    (a,), (b,) = _operands(rng, [(m, k, l, p)])
    want_best, want_idx = j_fused(jnp.asarray(a), jnp.asarray(b), interpret=True)
    best, idx = ss.fused_support_score(torch.from_numpy(a), torch.from_numpy(b))
    assert idx.dtype == torch.int32 and best.shape == (m, l)
    np.testing.assert_allclose(
        best.numpy(), np.asarray(want_best), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_grouped_plain_matches_jax_kernel():
    rng = np.random.default_rng(0)
    a, b = _operands(rng, GROUPED_SHAPES)
    want = j_grouped(
        [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b],
        interpret=True,
    )
    got = ss.grouped_support_score(
        [torch.from_numpy(x) for x in a], [torch.from_numpy(x) for x in b]
    )
    for (best, idx), (wb, wi) in zip(got, want):
        np.testing.assert_allclose(
            best.numpy(), np.asarray(wb), rtol=1e-5, atol=1e-5
        )
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))


@pytest.mark.parametrize("grouped", [False, True])
def test_tie_break_first(grouped):
    """Exact score ties resolve to the FIRST permutation, as in JAX."""
    a, b = torch.ones(4, 8), torch.ones(5, 8, 3)
    if grouped:
        outs = ss.grouped_support_score([a, a], [b, b])
        want = j_grouped([jnp.ones((4, 8))] * 2, [jnp.ones((5, 8, 3))] * 2,
                         interpret=True)
    else:
        outs = [ss.fused_support_score(a, b)]
        want = [j_fused(jnp.ones((4, 8)), jnp.ones((5, 8, 3)), interpret=True)]
    for (_, idx), (_, wi) in zip(outs, want):
        assert torch.all(idx == 0)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))


def test_plain_gradients_match_jax_vjp():
    """Autograd through the plain version equals the JAX scorer's custom
    VJP (gradient only through the chosen permutation)."""
    rng = np.random.default_rng(7)
    (a,), (b,) = _operands(rng, [(10, 24, 6, 4)])

    def loss_jax(a, b):
        best, _ = j_fused(a, b, interpret=True)
        return jnp.sum(best * best)

    want = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    best, _ = ss.support_score_plain(ta, tb)
    (best * best).sum().backward()
    for g, w in zip((ta.grad, tb.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_cpu_tensors_never_launch():
    before = (ss.fused_support_score.launches, ss.grouped_support_score.launches)
    a, b = torch.randn(5, 6), torch.randn(2, 6, 3)
    ss.fused_support_score(a, b)
    ss.grouped_support_score([a, a], [b, b])
    assert (
        ss.fused_support_score.launches,
        ss.grouped_support_score.launches,
    ) == before


def test_non_cpu_tensor_never_reaches_plain():
    """A tensor off the CPU goes to the kernel or raises: here a device the
    kernel does not serve raises instead of falling back."""
    a = torch.empty(5, 6, device="meta")
    b = torch.empty(2, 6, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ss.fused_support_score(a, b)
    with pytest.raises(ValueError, match="several devices"):
        ss.grouped_support_score([torch.randn(5, 6)], [b])
