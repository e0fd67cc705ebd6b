"""K2, the GNN aggregation ``A(x) @ H``, of the PyTorch port against the JAX
package's ``ops/pallas_flocking.py`` on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py runs it.  Inputs are made with numpy from a
seed, as f32.  Tolerances: the degree exactly; ``out`` and the gradients
to atol 2e-4, the JAX tests' own (the port accumulates in f64, JAX in f32).
The edge-case swarms of ``chip_smoke.edge_swarms`` (and one with a NaN
position) and F in {1, 9, 16} are held to the interpret-mode kernel too.
The CUDA kernel adds H only on the neighbour pairs; the premise tests hold
that sum equal to the plain version's on finite H, and pin the plain
version's NaN where a non-neighbour's H row is not finite (the kernel skips
it: a known deviation).
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
from chip_smoke import EDGE_CASES, edge_swarms
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


EDGE_ADJ_CASES = EDGE_CASES + ("nan position",)


def edge_case(case, cr):
    """``chip_smoke.edge_swarms``; ``"nan position"`` is "band" with agent
    5's position NaN (a neighbour of nobody)."""
    x = edge_swarms("band" if case == "nan position" else case, cr)
    if case == "nan position":
        x[:, 5, :2] = np.nan
    return x


def _jax_block(xr, xc, h, row_offset, col_offset, cr2):
    out, deg = jax_adjacency_matmul_block(jnp.asarray(xr), jnp.asarray(xc), jnp.asarray(h),
                                          row_offset, col_offset, cr2, interpret=True)
    return np.asarray(out), np.asarray(deg)


@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_ADJ_CASES)
def test_edge_cases_equal_jax(case, cr):
    x = edge_case(case, cr)
    h = feats(x.shape[0], x.shape[1], 6, 30)
    got, deg = k2.adjacency_matmul_block(t(x), t(x), t(h), 0, 0, cr * cr)
    want, want_deg = _jax_block(x, x, h, 0, 0, cr * cr)
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if case in ("all in reach", "none in reach"):
        assert bool((deg == (x.shape[1] - 1 if case == "all in reach" else 0)).all())


@pytest.mark.parametrize("f", [1, 9, 16])
def test_feature_widths_equal_jax(f):
    """Rows 130..259 against columns 0..299 of one swarm: ragged, and each
    row's own column lies in the second 128-column tile."""
    x, h = swarm(2, 300, 31, spread=1.5), feats(2, 300, f, 32)
    xr = x[:, 130:260]
    got, deg = k2.adjacency_matmul_block(t(xr), t(x), t(h), 130, 0, CR2)
    want, want_deg = _jax_block(xr, x, h, 130, 0, CR2)
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def hit_only_block(xr, xc, h, row_offset, col_offset, cr2):
    """The CUDA kernel's sums: for each row, the f64 sum of h over its
    neighbours only, in column order, rounded to f32 once."""
    b, m, _ = xr.shape
    out = torch.zeros(b, m, h.shape[-1], dtype=torch.float64)
    deg = torch.zeros(b, m)
    cols = col_offset + torch.arange(xc.shape[1])
    cr2 = torch.tensor(cr2, dtype=torch.float32)
    for s in range(b):
        for i in range(m):
            dx = xc[s, :, 0] - xr[s, i, 0]
            dy = xc[s, :, 1] - xr[s, i, 1]
            hit = (dx * dx + dy * dy < cr2) & (cols != row_offset + i)
            for j in hit.nonzero()[:, 0].tolist():
                out[s, i] += h[s, j].double()
            deg[s, i] = float(hit.sum())
    return out.to(torch.float32), deg


@pytest.mark.parametrize("case", ["band", "all in reach", "nan position", "ragged block"])
def test_plain_version_equals_the_sum_over_neighbours_only(case):
    """On finite H, skipping the non-neighbours changes no sum."""
    if case == "ragged block":
        x = t(swarm(2, 300, 33, spread=1.5))
        xr, xc, ro, co, cr2 = x[:, 130:260].contiguous(), x, 130, 0, CR2
    else:
        xr = xc = t(edge_case(case, 2.0))
        ro, co, cr2 = 0, 0, 4.0
    h = t(feats(xc.shape[0], xc.shape[1], 3, 34))
    got, deg = k2.adjacency_matmul_block(xr, xc, h, ro, co, cr2)
    want, want_deg = hit_only_block(xr, xc, h, ro, co, cr2)
    assert torch.equal(deg, want_deg) and torch.equal(got, want)


def test_plain_version_is_nan_where_a_non_neighbour_h_row_is_not_finite():
    """The known deviation: the plain version (as JAX's matmul) adds
    0 * NaN = NaN from a non-neighbour's H row; the kernel skips the row."""
    x = t(edge_swarms("none in reach", 0.9))
    h = t(feats(2, x.shape[1], 2, 35))
    h[0, 7] = float("nan")
    h[1, 9] = float("inf")
    got, deg = k2.adjacency_matmul_block(x, x, h, 0, 0, CR2)
    assert not deg.any()
    assert bool(got.isnan().all())


def test_positions_of_another_width_are_packed_into_aligned_rows():
    x = t(swarm(2, 50, 36))
    assert k2._position_rows(x) is x
    for cols in (2, 3, 5):
        wide = torch.cat([x, x], dim=-1)[..., :cols]
        rows = k2._position_rows(wide)
        assert rows.shape == (2, 50, 4) and rows.data_ptr() % 16 == 0
        assert torch.equal(rows[..., :2], x[..., :2]) and not rows[..., 2:].any()


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
def test_k2_float64_on_the_card_raises(cuda):
    x, h = t(swarm(2, 64, 37)).to(cuda), t(feats(2, 64, 6, 38)).to(cuda)
    for args in ((x.double(), x, h), (x, x, h.double())):
        with pytest.raises(TypeError):
            k2._adj(*args, 0, 0, CR2)


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
    chunks = k2.launches_for(hc.shape[-1])  # F=13: two launches a pass
    assert (k2.launches, k2.backward_launches) == (before[0] + 2 * chunks, before[1] + chunks)
    want, want_deg = k2.adjacency_matmul_block_reference(xr, xc, hc.detach(), row_offset,
                                                         col_offset, CR2)
    want_g, _ = k2.adjacency_matmul_block_reference(xc, xr, torch.ones_like(got), col_offset,
                                                    row_offset, CR2)
    assert torch.equal(deg, want_deg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(hc.grad, want_g, rtol=0, atol=1e-6)
