"""K2, the GNN aggregation ``A(x) @ H``, of the PyTorch port against the JAX
package's ``ops/pallas_flocking.py`` on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py runs it.  Inputs are made with numpy from a
seed, as f32.  Tolerances: the degree exactly; ``out`` and the gradients
to atol 2e-4, the JAX tests' own (the port accumulates in f64, JAX in f32).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_flock_tpu.ops.pallas_flocking import (
    adjacency_matmul as jax_adjacency_matmul,
    adjacency_matmul_block as jax_adjacency_matmul_block,
    khop_aggregate as jax_khop_aggregate,
)
from gym_flock_tpu_torch.ops import adjacency_matmul as k2

torch.set_num_threads(2)

CR2 = 0.81
ATOL = 2e-4


def swarm(b, n, seed, spread=2.0):
    """Standard normal states with positions scaled by ``spread``."""
    x = np.random.RandomState(seed).standard_normal((b, n, 4)).astype(np.float32)
    x[..., :2] *= spread
    return x


def feats(b, n, f, seed):
    return np.random.RandomState(seed).standard_normal((b, n, f)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (n, F, B, seed): the shapes of tests/test_pallas_kernels.py:45-64 and
# :282-320, the first batched
CASES = [(200, 16, 2, 2), (48, 5, 1, 7)]


@pytest.mark.parametrize("mean_pool", [False, True])
@pytest.mark.parametrize("n,f,b,seed", CASES)
def test_adjacency_matmul_and_its_gradient_equal_jax(n, f, b, seed, mean_pool):
    x, h = swarm(b, n, seed), feats(b, n, f, seed + 1)
    co = feats(b, n, f, seed + 2)
    want = jax_adjacency_matmul(jnp.asarray(x), jnp.asarray(h), CR2, mean_pool=mean_pool,
                                interpret=True)
    want_g = jax.grad(lambda hv: jnp.sum(jax_adjacency_matmul(
        jnp.asarray(x), hv, CR2, mean_pool=mean_pool, interpret=True) * co))(jnp.asarray(h))

    xt, ht = t(x).requires_grad_(), t(h).requires_grad_()
    got = k2.adjacency_matmul(xt, ht, CR2, mean_pool=mean_pool)
    (got * t(co)).sum().backward()
    assert got.shape == (b, n, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g), atol=ATOL)
    # the positions: the a.e. gradient of a step function
    assert not xt.grad.any()


# (m, k, row_offset, col_offset): ids overlapping in part, the same block,
# disjoint ids, and an empty overlap at the edge; none a multiple of 128
BLOCKS = [(150, 130, 0, 70), (137, 137, 0, 0), (90, 200, 300, 0), (129, 61, 64, 193)]


@pytest.mark.parametrize("m,k,row_offset,col_offset", BLOCKS)
def test_adjacency_matmul_block_and_its_gradient_equal_jax(m, k, row_offset, col_offset):
    # rows and columns cut from one swarm of 400 agents at their global ids
    x, h = swarm(2, 400, 11, spread=1.5), feats(2, 400, 6, 12)
    xr, xc = x[:, row_offset:row_offset + m], x[:, col_offset:col_offset + k]
    hc = h[:, col_offset:col_offset + k]
    co = feats(2, m, 6, 13)

    def jax_block(hv):
        return jax_adjacency_matmul_block(jnp.asarray(xr), jnp.asarray(xc), hv, row_offset,
                                          col_offset, CR2, interpret=True)

    want, want_deg = jax_block(jnp.asarray(hc))
    want_g = jax.grad(lambda hv: jnp.sum(jax_block(hv)[0] * co))(jnp.asarray(hc))

    ht = t(hc).requires_grad_()
    got, deg = k2.adjacency_matmul_block(t(xr), t(xc), ht, row_offset, col_offset, CR2)
    (got * t(co)).sum().backward()
    assert deg.dtype == torch.float32 and deg.shape == (2, m)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g), atol=ATOL)


def test_blocks_sum_to_the_whole_swarm():
    """Row blocks against column blocks at their global ids, summed over the
    column blocks, give the whole swarm's product and degree."""
    x, h = swarm(1, 300, 14, spread=1.5), feats(1, 300, 5, 15)
    whole, whole_deg = k2.adjacency_matmul_block(t(x), t(x), t(h), 0, 0, CR2)
    cuts = [0, 100, 230, 300]
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        parts = [k2.adjacency_matmul_block(t(x[:, r0:r1]), t(x[:, c0:c1]), t(h[:, c0:c1]),
                                           r0, c0, CR2)
                 for c0, c1 in zip(cuts[:-1], cuts[1:])]
        np.testing.assert_array_equal(sum(d for _, d in parts).numpy(),
                                      whole_deg[:, r0:r1].numpy())
        np.testing.assert_allclose(sum(o for o, _ in parts).numpy(),
                                   whole[:, r0:r1].numpy(), atol=1e-5)


@pytest.mark.parametrize("mean_pool", [False, True])
def test_rows_of_degree_zero_equal_jax(mean_pool):
    # a spread swarm: many agents have no neighbour, and their rows are 0
    x, h = swarm(1, 130, 16, spread=20.0), feats(1, 130, 6, 17)
    _, deg = k2.adjacency_matmul_block(t(x), t(x), t(h), 0, 0, CR2)
    assert 0 < int((deg == 0).sum()) < 130
    ht = t(h).requires_grad_()
    got = k2.adjacency_matmul(t(x), ht, CR2, mean_pool=mean_pool)
    got.sum().backward()
    want = jax_adjacency_matmul(jnp.asarray(x), jnp.asarray(h), CR2, mean_pool=mean_pool,
                                interpret=True)
    want_g = jax.grad(lambda hv: jnp.sum(jax_adjacency_matmul(
        jnp.asarray(x), hv, CR2, mean_pool=mean_pool, interpret=True)))(jnp.asarray(h))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g), atol=ATOL)
    assert not got[deg == 0].any()


def test_khop_aggregate_equals_jax():
    x, h = swarm(2, 100, 3, spread=1.0), feats(2, 100, 6, 4)
    got = k2.khop_aggregate(t(x), t(h), CR2, k_hops=3)
    want = jax_khop_aggregate(jnp.asarray(x), jnp.asarray(h), CR2, k_hops=3, interpret=True)
    assert got.shape == (2, 100, 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_bf16_h_keeps_its_dtype_and_deg_stays_f32():
    x, h = swarm(1, 140, 18), feats(1, 140, 8, 19)
    hb = t(h).to(torch.bfloat16)
    out, deg = k2.adjacency_matmul_block(t(x), t(x), hb, 0, 0, CR2)
    assert out.dtype == torch.bfloat16 and deg.dtype == torch.float32
    want, want_deg = k2.adjacency_matmul_block(t(x), t(x), hb.float(), 0, 0, CR2)
    np.testing.assert_array_equal(deg.numpy(), want_deg.numpy())
    assert torch.equal(out, want.to(torch.bfloat16))
    hg = hb.clone().requires_grad_()
    k2.adjacency_matmul(t(x), hg, CR2).float().sum().backward()
    assert hg.grad.dtype == torch.bfloat16 and hg.grad.shape == hb.shape


# --------------------------------------------------------- the wrapper


def _bad_inputs():
    x, h = t(swarm(2, 64, 20)), t(feats(2, 64, 6, 21))
    return {
        "float64 x": (x.double(), x, h),
        "float64 h": (x, x, h.double()),
        "int h": (x, x, h.int()),
        "unbatched": (x[0], x[0], h[0]),
        "one column": (x[..., :1].contiguous(), x, h),
        "batch": (x[:1], x, h),
        "h rows": (x, x, h[:, :10]),
        "no features": (x, x, h[..., :0]),
        "non_contiguous": (x.transpose(0, 1).contiguous().transpose(0, 1), x, h),
    }


@pytest.mark.parametrize("name", sorted(_bad_inputs()))
def test_k2_wrapper_rejects_bad_inputs(name):
    xr, xc, h = _bad_inputs()[name]
    with pytest.raises((TypeError, ValueError)):
        k2._adj(xr, xc, h, 0, 0, CR2)


def test_k2_wrapper_raises_on_a_device_other_than_cpu_or_cuda():
    x = torch.empty(1, 128, 4, device="meta")
    h = torch.empty(1, 128, 6, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k2.adjacency_matmul_block(x, x, h, 0, 0, CR2)


def test_k2_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, h = t(swarm(2, 64, 22)), t(feats(2, 64, 6, 23))
    before = (k2.launches, k2.backward_launches)
    got = k2.adjacency_matmul_block(x, x, h, 0, 0, CR2)
    want = k2.adjacency_matmul_block_reference(x, x, h, 0, 0, CR2)
    assert (k2.launches, k2.backward_launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,row_offset,col_offset", BLOCKS)
def test_k2_matches_plain_on_the_card(cuda, m, k, row_offset, col_offset):
    x, h = swarm(2, 400, 11, spread=1.5), feats(2, 400, 13, 12)
    xr = t(x[:, row_offset:row_offset + m]).to(cuda)
    xc = t(x[:, col_offset:col_offset + k]).to(cuda)
    hc = t(h[:, col_offset:col_offset + k]).to(cuda).requires_grad_()
    before = (k2.launches, k2.backward_launches)
    got, deg = k2.adjacency_matmul_block(xr, xc, hc, row_offset, col_offset, CR2)
    got.sum().backward()
    torch.cuda.synchronize()
    assert (k2.launches, k2.backward_launches) == (before[0] + 2, before[1] + 1)
    want, want_deg = k2.adjacency_matmul_block_reference(xr, xc, hc.detach(), row_offset,
                                                         col_offset, CR2)
    want_g, _ = k2.adjacency_matmul_block_reference(xc, xr, torch.ones_like(got), col_offset,
                                                    row_offset, CR2)
    assert torch.equal(deg, want_deg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(hc.grad, want_g, rtol=0, atol=1e-6)
