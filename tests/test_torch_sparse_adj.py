"""K4, the cell-list GNN aggregation, of the PyTorch port against the JAX
package's ``ops/sparse_flocking.py`` on the CPU.

Inputs are made with numpy from a seed, as f32.  K4's plain version is held
against ``_sparse_adj_xla`` on the same sorted inputs and table;
``adjacency_matmul_sparse`` and ``khop_aggregate_sparse`` against JAX's,
with their gradients.  Tolerances: tables, overflow flags and the degree
exactly; ``out`` and the gradients to atol 2e-4, the JAX tests' own (the
port accumulates in f64, JAX in f32).  The plain version also runs on the
edge-case swarms of ``chip_smoke.edge_swarms`` (and one with a NaN
position) and at F in {1, 9, 16} against the Pallas kernel in interpret
mode, and in float64 against ``_sparse_adj_xla`` under x64 (1e-9, the x64
parity tests' tolerance).  The CUDA kernel adds H only on the neighbour
pairs; the premise tests hold that sum equal to the plain version's on
finite H, and pin the plain version's NaN where a non-neighbour's H row is
not finite (the kernel skips it: a known deviation).
"""
import functools
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_flock_tpu.ops import sparse_flocking as jsf
from gym_flock_tpu.ops.pallas_flocking import adjacency_matmul as jax_adjacency_matmul
from chip_smoke import EDGE_CASES, edge_swarms
from gym_flock_tpu_torch.ops import adjacency_matmul as k2
from gym_flock_tpu_torch.ops import sparse_flocking as sf

torch.set_num_threads(2)

CR2 = 0.81
ATOL = 2e-4
K_MAX = 16


def normal_swarms(b, n, seed, spread):
    x = np.random.RandomState(seed).standard_normal((b, n, 4)).astype(np.float32)
    x[..., :2] *= spread
    return x


def uniform_swarms(b, n, seed):
    """Bench metric 4's state: about one agent per unit^2."""
    rng = np.random.RandomState(seed)
    x = np.empty((b, n, 4), np.float32)
    x[..., :2] = rng.uniform(0.0, math.sqrt(n), (b, n, 2))
    x[..., 2:] = rng.standard_normal((b, n, 2))
    return x


def feats(b, n, f, seed):
    return np.random.RandomState(seed).standard_normal((b, n, f)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


STATES = {
    "uniform N=1024": lambda: uniform_swarms(2, 1024, seed=1),
    "normal N=512": lambda: normal_swarms(2, 512, seed=2, spread=8.0),
    "normal N=256": lambda: normal_swarms(1, 256, seed=3, spread=6.0),
    # every one of the 4 blocks within reach of every other: a table of
    # k_max < 4 overflows
    "clustered N=512": lambda: normal_swarms(2, 512, seed=4, spread=0.5),
}


def _sorted_operands(x, h):
    """The port's sort and table at sqrt(CR2), as the pipeline builds them."""
    xt = t(x)
    cr = torch.sqrt(torch.tensor(CR2, dtype=torch.float32))
    perm = sf.hilbert_order(xt, cr)
    xs = sf.permute(xt, perm)
    table, overflow = sf.block_pair_table(xs, cr, K_MAX)
    return xs, sf.permute(t(h), perm), table, overflow


@pytest.mark.parametrize("name", ["uniform N=1024", "normal N=512", "normal N=256"])
def test_plain_k4_equals_sparse_adj_xla(name):
    x = STATES[name]()
    xs, hs, table, overflow = _sorted_operands(x, feats(x.shape[0], x.shape[1], 6, 5))
    assert not overflow.any()
    # the table is JAX's, built at JAX's cr = sqrt(cr2) in f32
    cr = jnp.sqrt(jnp.float32(CR2))
    want_table, _ = jax.vmap(lambda a: jsf.block_pair_table(a, cr, K_MAX))(jnp.asarray(xs.numpy()))
    np.testing.assert_array_equal(table.numpy(), np.asarray(want_table))
    got, deg = sf.sparse_adj_sorted(xs, hs, table, CR2)
    want, want_deg = jsf._sparse_adj_xla(jnp.asarray(xs.numpy()), jnp.asarray(hs.numpy()),
                                         jnp.asarray(table.numpy()), CR2)
    assert got.dtype == torch.float32 and deg.dtype == torch.float32
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_k4_skips_pad_slots_anywhere_in_the_row():
    """Pads first and past the listed blocks give the compacted table's sums."""
    x = STATES["normal N=512"]()
    xs, hs, table, _ = _sorted_operands(x, feats(2, 512, 5, 6))
    pads = torch.full_like(table[..., :3], -1)
    ragged = torch.cat([pads, table.flip(-1), pads], dim=-1).contiguous()
    got, deg = sf.sparse_adj_sorted(xs, hs, ragged, CR2)
    want, want_deg = sf.sparse_adj_sorted(xs, hs, table, CR2)
    assert torch.equal(deg, want_deg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_k4_degree_equals_dense_k2():
    """The pruning is exact: the sorted degree through the table equals the
    dense K2 degree of the same sorted swarm."""
    x = STATES["uniform N=1024"]()
    xs, hs, table, _ = _sorted_operands(x, feats(2, 1024, 6, 7))
    _, deg = sf.sparse_adj_sorted(xs, hs, table, CR2)
    out_d, deg_d = k2.adjacency_matmul_block(xs, xs, hs, 0, 0, CR2)
    assert torch.equal(deg, deg_d)
    torch.testing.assert_close(sf.sparse_adj_sorted(xs, hs, table, CR2)[0], out_d,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mean_pool", [False, True])
@pytest.mark.parametrize("name,k_max,overflows", [
    ("normal N=512", K_MAX, False), ("clustered N=512", 2, True)])
def test_adjacency_matmul_sparse_and_its_gradient_equal_jax(name, k_max, overflows,
                                                           mean_pool):
    x = STATES[name]()
    b, n, _ = x.shape
    h, co = feats(b, n, 6, 8), feats(b, n, 6, 9)

    def jax_fn(hv):
        return jsf.adjacency_matmul_sparse(jnp.asarray(x), hv, CR2, mean_pool=mean_pool,
                                           k_max=k_max)

    want = jax_fn(jnp.asarray(h))
    want_g = jax.grad(lambda hv: jnp.sum(jax_fn(hv) * co))(jnp.asarray(h))

    overflowed = sf.adj_overflow_passes
    xt, ht = t(x).requires_grad_(), t(h).requires_grad_()
    got = sf.adjacency_matmul_sparse(xt, ht, CR2, mean_pool=mean_pool, k_max=k_max)
    (got * t(co)).sum().backward()
    # an overflowing batch's forward and backward passes both take dense K2
    assert sf.adj_overflow_passes - overflowed == (2 if overflows else 0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g), atol=ATOL)
    assert not xt.grad.any()


def test_sparse_equals_dense_aggregation():
    x, h = STATES["uniform N=1024"](), feats(2, 1024, 6, 10)
    got = sf.adjacency_matmul_sparse(t(x), t(h), CR2)
    want = k2.adjacency_matmul(t(x), t(h), CR2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_khop_aggregate_sparse_equals_jax():
    x, h = STATES["normal N=256"](), feats(1, 256, 6, 11)
    got = sf.khop_aggregate_sparse(t(x), t(h), CR2, k_hops=3)
    want = jsf.khop_aggregate_sparse(jnp.asarray(x), jnp.asarray(h), CR2, k_hops=3)
    dense = jax_adjacency_matmul(jnp.asarray(x), jnp.asarray(h), CR2, interpret=True)
    assert got.shape == (1, 256, 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got[..., 6:12].numpy(), np.asarray(dense), atol=ATOL)


def test_bf16_h_keeps_its_dtype_and_deg_stays_f32():
    """tests/test_sparse_flocking.py:496's contract: out in h's dtype, deg in
    f32, on both branches, and a gradient of h's shape."""
    for name in ("normal N=256", "clustered N=512"):  # the second overflows k_max=2
        x = STATES[name]()
        hb = t(feats(x.shape[0], x.shape[1], 8, 12)).to(torch.bfloat16)
        xs, hs, table, overflow = _sorted_operands(x, hb.float().numpy())
        if not overflow.any():
            out, deg = sf.sparse_adj_sorted(xs, hs.to(torch.bfloat16), table, CR2)
            assert out.dtype == torch.bfloat16 and deg.dtype == torch.float32
        hg = hb.clone().requires_grad_()
        out = sf.adjacency_matmul_sparse(t(x), hg, CR2, k_max=2)
        assert out.dtype == torch.bfloat16 and out.shape == hb.shape
        out.float().sum().backward()
        assert hg.grad.dtype == torch.bfloat16 and hg.grad.shape == hb.shape


# --------------------------------------------------------- the wrapper


def _bad_inputs():
    xs, hs, table, _ = _sorted_operands(STATES["normal N=256"](), feats(1, 256, 6, 13))
    return {
        "float64 xs": (xs.double(), hs, table),
        "float64 hs": (xs, hs.double(), table),
        "int64 table": (xs, hs, table.long()),
        "ragged N": (xs[:, :200].contiguous(), hs[:, :200].contiguous(), table),
        "hs rows": (xs, hs[:, :128].contiguous(), table),
        "no features": (xs, hs[..., :0], table),
        "table rows": (xs, hs, table[:, :1].contiguous()),
        "non_contiguous hs": (xs, hs.transpose(1, 2).contiguous().transpose(1, 2), table),
    }


@pytest.mark.parametrize("name", sorted(_bad_inputs()))
def test_k4_wrapper_rejects_bad_inputs(name):
    """Bad inputs raise, but for three that the wrapper now takes on the
    CPU: float64 xs or hs run the plain version (out in hs's type, deg
    f32), and a non-contiguous hs gives the contiguous one's result."""
    xs, hs, table = _bad_inputs()[name]
    if name.startswith("float64"):
        out, deg = sf.sparse_adj_sorted(xs, hs, table, CR2)
        want, want_deg = sf.sparse_adj_sorted_reference(xs, hs, table, CR2)
        assert out.dtype == hs.dtype and deg.dtype == torch.float32
        assert torch.equal(out, want) and torch.equal(deg, want_deg)
    elif name == "non_contiguous hs":
        got = sf.sparse_adj_sorted(xs, hs, table, CR2)
        want = sf.sparse_adj_sorted(xs, hs.contiguous(), table, CR2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        with pytest.raises((TypeError, ValueError)):
            sf.sparse_adj_sorted(xs, hs, table, CR2)


def test_k4_float64_equals_sparse_adj_xla_x64():
    """``_sparse_adj_xla`` runs at x64 and returns f64: so does the plain
    version on the CPU, without rounding to f32."""
    x = STATES["normal N=512"]()
    xs, hs, table, _ = _sorted_operands(x, feats(2, 512, 6, 24))
    xs64, hs64 = xs.double(), hs.double()
    got, deg = sf.sparse_adj_sorted(xs64, hs64, table, CR2)
    with jax.enable_x64(True):
        want, want_deg = jsf._sparse_adj_xla(jnp.asarray(xs64.numpy()), jnp.asarray(hs64.numpy()),
                                             jnp.asarray(table.numpy()), CR2)
        want, want_deg = np.asarray(want), np.asarray(want_deg)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    assert np.max(np.abs(got.numpy() - want) / (1.0 + np.abs(want))) < 1e-9


def _edge_sorted(case, cr, f, seed):
    """An edge-case swarm (``"nan position"``: "band" with agent 5's
    position NaN), its features and table, sorted at ``cr`` as the pipeline
    sorts them."""
    x = edge_swarms("band" if case == "nan position" else case, cr)
    if case == "nan position":
        x[:, 5, :2] = np.nan
    xt = t(x)
    perm = sf.hilbert_order(xt, cr)
    xs = sf.permute(xt, perm)
    table, _ = sf.block_pair_table(xs, cr, K_MAX)
    return xs, sf.permute(t(feats(x.shape[0], x.shape[1], f, seed)), perm), table


EDGE_ADJ_CASES = EDGE_CASES + ("nan position",)


def _jax_sorted(xs, hs, table, cr2):
    out, deg = jsf._sparse_adj_pallas(jnp.asarray(xs.numpy()), jnp.asarray(hs.numpy()),
                                      jnp.asarray(table.numpy()), cr2, interpret=True)
    return np.asarray(out), np.asarray(deg)


@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_ADJ_CASES)
def test_plain_k4_edge_cases_equal_the_pallas_kernel(case, cr):
    xs, hs, table = _edge_sorted(case, cr, 6, 25)
    got, deg = sf.sparse_adj_sorted(xs, hs, table, cr * cr)
    want, want_deg = _jax_sorted(xs, hs, table, cr * cr)
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if case in ("all in reach", "none in reach"):
        assert bool((deg == (xs.shape[1] - 1 if case == "all in reach" else 0)).all())


@pytest.mark.parametrize("f", [1, 9, 16])
def test_plain_k4_feature_widths_equal_the_pallas_kernel(f):
    xs, hs, table, _ = _sorted_operands(STATES["normal N=512"](), feats(2, 512, f, 26))
    got, deg = sf.sparse_adj_sorted(xs, hs, table, CR2)
    want, want_deg = _jax_sorted(xs, hs, table, CR2)
    np.testing.assert_array_equal(deg.numpy(), want_deg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def hit_only_sorted(xs, hs, table, cr2):
    """The CUDA kernel's sums: for each row, the f64 sum of hs over its
    neighbours only, slot by slot in column order, rounded to f32 once."""
    b, n, f = hs.shape
    out = torch.zeros(b, n, f, dtype=torch.float64)
    deg = torch.zeros(b, n)
    cr2 = torch.tensor(cr2, dtype=torch.float32)
    for s in range(b):
        for i in range(n):
            for j in table[s, i // sf.BLOCK].tolist():
                if j < 0:
                    continue
                cols = torch.arange(j * sf.BLOCK, (j + 1) * sf.BLOCK)
                dx = xs[s, cols, 0] - xs[s, i, 0]
                dy = xs[s, cols, 1] - xs[s, i, 1]
                hit = (dx * dx + dy * dy < cr2) & (cols != i)
                for c in cols[hit].tolist():
                    out[s, i] += hs[s, c].double()
                deg[s, i] += float(hit.sum())
    return out.to(torch.float32), deg


@pytest.mark.parametrize("case", ["band", "all in reach", "nan position"])
def test_plain_k4_equals_the_sum_over_neighbours_only(case):
    """On finite H, skipping the non-neighbours changes no sum."""
    xs, hs, table = _edge_sorted(case, 2.0, 3, 27)
    got, deg = sf.sparse_adj_sorted(xs, hs, table, 4.0)
    want, want_deg = hit_only_sorted(xs, hs, table, 4.0)
    assert torch.equal(deg, want_deg) and torch.equal(got, want)


def test_plain_k4_is_nan_where_a_non_neighbour_h_row_is_not_finite():
    """The known deviation: the plain version (as JAX's matmul) adds
    0 * NaN = NaN from a non-neighbour's H row; the kernel skips the row."""
    xs, hs, table = _edge_sorted("none in reach", 0.9, 2, 28)
    hs[0, 7] = float("nan")
    hs[1, 9] = float("inf")
    got, deg = sf.sparse_adj_sorted(xs, hs, table, CR2)
    assert not deg.any()
    rows = torch.arange(xs.shape[1]) // sf.BLOCK
    listed = [(table[0, rows] == 7 // sf.BLOCK).any(-1), (table[1, rows] == 9 // sf.BLOCK).any(-1)]
    for s in range(2):
        assert torch.equal(got[s].isnan().any(-1), listed[s])


def test_k4_wrapper_raises_on_a_device_other_than_cpu_or_cuda():
    xs = torch.empty(1, 128, 4, device="meta")
    hs = torch.empty(1, 128, 6, device="meta")
    table = torch.empty(1, 1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sf.sparse_adj_sorted(xs, hs, table, CR2)


def test_k4_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    xs, hs, table, _ = _sorted_operands(STATES["normal N=256"](), feats(1, 256, 6, 14))
    before = (sf.adj_launches, sf.adj_backward_launches, k2.launches)
    got = sf.sparse_adj_sorted(xs, hs, table, CR2)
    want = sf.sparse_adj_sorted_reference(xs, hs, table, CR2)
    assert (sf.adj_launches, sf.adj_backward_launches, k2.launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_large_gnn_takes_the_sparse_aggregation():
    """``LargeAggregationGNN`` with ``khop_aggregate_sparse`` as its
    ``aggregate_fn`` gives the dense model's output with the same weights."""
    from gym_flock_tpu_torch.models import LargeAggregationGNN

    x, f = STATES["normal N=256"](), feats(1, 256, 6, 15)
    gen = torch.Generator().manual_seed(0)
    dense = LargeAggregationGNN(comm_radius2=CR2, generator=gen)
    sparse = LargeAggregationGNN(
        comm_radius2=CR2,
        aggregate_fn=functools.partial(sf.khop_aggregate_sparse, comm_radius2=CR2, k_hops=3))
    sparse.load_state_dict(dense.state_dict())
    torch.testing.assert_close(sparse(t(x), t(f)), dense(t(x), t(f)), rtol=0, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k4_float64_on_the_card_raises(cuda):
    xs, hs, table, _ = _sorted_operands(STATES["normal N=256"](), feats(1, 256, 6, 29))
    xs, hs, table = xs.to(cuda), hs.to(cuda), table.to(cuda)
    for args in ((xs.double(), hs), (xs, hs.double())):
        with pytest.raises(TypeError, match="float32"):
            sf.sparse_adj_sorted(*args, table, CR2)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uniform N=1024", "normal N=512"])
def test_k4_matches_plain_on_the_card(cuda, name):
    x = STATES[name]()
    xs, hs, table, _ = _sorted_operands(x, feats(x.shape[0], x.shape[1], 13, 16))
    xs, hs, table = xs.to(cuda), hs.to(cuda), table.to(cuda)
    before = sf.adj_launches
    got, deg = sf.sparse_adj_sorted(xs, hs, table, CR2)
    torch.cuda.synchronize()
    assert sf.adj_launches == before + k2.launches_for(hs.shape[-1])  # F=13: two
    want, want_deg = sf.sparse_adj_sorted_reference(xs, hs, table, CR2)
    assert torch.equal(deg, want_deg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
