"""K1 (the flocking pairwise channel sums) in the PyTorch port against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

Tolerances: the degree (channel 8) exactly; channel 9 (min r^2) within
1 ulp (XLA may contract dx*dx + dy*dy into an FMA); every other channel
max |port - jax| / (1 + |jax|) < 1e-4, the measure of
tests/test_pallas_kernels.py (the 1/r^4 sums are large and the summation
orders differ).  Where two coincident agents make sums NaN, the NaN lie in
the same places and the degree is exact.

The CUDA kernel runs its arithmetic only on the pairs with r2 < cr2 or not
r2 > cr; the premise tests hold the plain version equal, bit for bit with
NaN equal, to the same sums over those pairs only, on the edge-case swarms
of ``chip_smoke.edge_swarms``.

On the CPU the plain version also takes float64, as the JAX package's XLA
path runs under ``jax_enable_x64``: held to ``_flocking_sums_xla`` at x64
with the degree exact and every other channel max |port - jax| / (1 + |jax|)
< 1e-9, the x64 parity tests' tolerance (both sum in f64, in other orders).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_flock_tpu.ops.pallas_flocking import _flocking_sums_xla
from gym_flock_tpu.ops.pallas_flocking import flocking_sums as jax_flocking_sums
from gym_flock_tpu.ops.pallas_flocking import flocking_sums_block as jax_flocking_sums_block
from chip_smoke import EDGE_CASES, edge_swarms
from gym_flock_tpu_torch.ops import flocking_sums as k1

torch.set_num_threads(2)

CR = 0.9
CR2 = CR * CR
SUM_TOL = 1e-4
X64_TOL = 1e-9


def _swarms(b, n, seed):
    return np.random.RandomState(seed).randn(b, n, 4).astype(np.float32) * 2


def _equal_nan(a, b):
    """Bit-for-bit equality of two f32 results, NaN equal to NaN."""
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def restricted_sums(xr, xc, row_offset, col_offset, cr, cr2, channels):
    """K1's plain version row by row over only the columns within reach of
    the row (r2 < cr2 or not r2 > cr, NaN included), in column order; the
    row's own column is kept and masked by id, as in the full pass."""
    b, m, _ = xr.shape
    out = torch.zeros(b, m, k1.N_OUT)
    col_ids = col_offset + torch.arange(xc.shape[1])
    for s in range(b):
        for i in range(m):
            d = xr[s, i, :2] - xc[s, :, :2]
            r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
            own = col_ids == row_offset + i
            keep = (r2 < cr2) | ~(r2 > cr) | own
            cols = xc[s:s + 1, keep].contiguous()
            at = own[keep].nonzero()
            row_id = int(at[0]) if len(at) else cols.shape[1]  # its own column, or none
            out[s, i] = k1.flocking_sums_block_reference(
                xr[s:s + 1, i:i + 1].contiguous(), cols, row_id, 0, cr, cr2, channels)[0, 0]
    return out


def _sum_channels(channels):
    return list(range(8)) + ([10, 11] if channels == "full" else [])


def _assert_k1_close(got, want, channels):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 8], want[..., 8])
    sums = _sum_channels(channels)
    rel = np.max(np.abs(got[..., sums] - want[..., sums]) / (1.0 + np.abs(want[..., sums])))
    assert rel < SUM_TOL, rel
    if channels == "full":
        np.testing.assert_array_max_ulp(got[..., 9], want[..., 9], maxulp=1)
    n_used = 12 if channels == "full" else 9
    assert not np.any(got[..., n_used:])


@pytest.mark.parametrize("n", [64, 137, 200])
def test_core_matches_pallas(n):
    x = _swarms(3, n, seed=n)
    got = k1.flocking_sums(torch.from_numpy(x), CR, CR2)
    want = jax_flocking_sums(jnp.asarray(x), CR, CR2, interpret=True)
    _assert_k1_close(got.numpy(), want, "core")


@pytest.mark.parametrize("n", [64, 137, 200])
@pytest.mark.parametrize("case", ["symmetric", "cross"])
def test_full_matches_pallas_block(n, case):
    x = _swarms(3, n, seed=1000 + n)
    if case == "symmetric":
        xr, xc, ro, co = x, x, 0, 0
    else:
        # rows: agents [0, 2n/3); columns: agents [n/3, n) -- the ids in
        # [n/3, 2n/3) appear on both sides and their self pairs must drop
        lo, hi = n // 3, (2 * n) // 3
        xr, xc, ro, co = x[:, :hi], x[:, lo:], 0, lo
    got = k1.flocking_sums_block(
        torch.from_numpy(np.ascontiguousarray(xr)), torch.from_numpy(np.ascontiguousarray(xc)),
        ro, co, CR, CR2, channels="full",
    )
    want = jax_flocking_sums_block(
        jnp.asarray(xr), jnp.asarray(xc), ro, co, CR, CR2, interpret=True, channels="full"
    )
    _assert_k1_close(got.numpy(), want, "full")


def test_column_tiles_combine_to_whole_swarm():
    """Rows against column blocks with global offsets, combined by + (and
    min for channel 9), give the whole-swarm result."""
    x = torch.from_numpy(_swarms(2, 150, seed=7))
    whole = k1.flocking_sums_block(x, x, 0, 0, CR, CR2, channels="full")
    rows = x[:, 40:110].contiguous()
    parts = [
        k1.flocking_sums_block(rows, x[:, a:b].contiguous(), 40, a, CR, CR2, channels="full")
        for a, b in [(0, 50), (50, 100), (100, 150)]
    ]
    combined = sum(parts)
    combined[..., 9] = torch.stack([p[..., 9] for p in parts]).amin(dim=0)
    _assert_k1_close(combined.numpy(), whole[:, 40:110].numpy(), "full")


@pytest.mark.parametrize("channels", ["core", "full"])
@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_version_sums_only_the_pairs_within_reach(case, cr, channels):
    """Every pair with r2 >= cr2 and r2 > cr adds exact zeros: dropping
    them leaves every channel but the min (9) unchanged, NaN included."""
    x = torch.from_numpy(edge_swarms(case, cr))
    want = k1.flocking_sums_block_reference(x, x, 0, 0, cr, cr * cr, channels)
    got = restricted_sums(x, x, 0, 0, cr, cr * cr, channels)
    sums = [c for c in range(k1.N_OUT) if c != 9]
    assert _equal_nan(got[..., sums], want[..., sums])
    assert bool(want.isnan().any()) == (case == "coincident pair")
    assert bool(want[..., :8].nan_to_num().any()) == (case != "none in reach")


@pytest.mark.parametrize("channels", ["core", "full"])
@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_cases_match_pallas(case, cr, channels):
    x = edge_swarms(case, cr)
    got = k1.flocking_sums_block(torch.from_numpy(x), torch.from_numpy(x), 0, 0, cr, cr * cr,
                                 channels=channels).numpy()
    want = np.asarray(jax_flocking_sums_block(jnp.asarray(x), jnp.asarray(x), 0, 0, cr, cr * cr,
                                              interpret=True, channels=channels))
    if case == "coincident pair":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[..., 8], want[..., 8])
        assert np.isnan(got).any()
    else:
        _assert_k1_close(got, want, channels)


def test_row_without_other_agents_has_infinite_min():
    """One agent alone: no pair, zero sums, channel 9 = +inf (the Pallas
    kernel reports its far-away padding distance there instead)."""
    x = torch.from_numpy(_swarms(2, 1, seed=3))
    s = k1.flocking_sums_block(x, x, 0, 0, CR, CR2, channels="full")
    assert torch.isinf(s[..., 9]).all()
    assert not s[..., :9].any() and not s[..., 10:].any()


def _bad_inputs():
    x = torch.from_numpy(_swarms(2, 16, seed=5))
    return {
        "float64": (x.double(), x.double(), "full"),
        "non_contiguous": (x.transpose(0, 1), x.transpose(0, 1), "full"),
        "unbatched": (x[0], x[0], "full"),
        "three_columns": (x[..., :3].contiguous(), x[..., :3].contiguous(), "full"),
        "batch_mismatch": (x, x[:1], "full"),
        "channels": (x, x, "expert"),
    }


@pytest.mark.parametrize("name", sorted(_bad_inputs()))
def test_wrapper_rejects_bad_inputs(name):
    """Bad inputs raise, but for two that the wrapper now takes on the CPU:
    float64 runs the plain version and returns float64, and a
    non-contiguous input gives the contiguous input's result."""
    xr, xc, channels = _bad_inputs()[name]
    if name == "float64":
        got = k1.flocking_sums_block(xr, xc, 0, 0, CR, CR2, channels=channels)
        assert got.dtype == torch.float64
        assert torch.equal(got, k1.flocking_sums_block_reference(xr, xc, 0, 0, CR, CR2, channels))
    elif name == "non_contiguous":
        got = k1.flocking_sums_block(xr, xc, 0, 0, CR, CR2, channels=channels)
        want = k1.flocking_sums_block(xr.contiguous(), xc.contiguous(), 0, 0, CR, CR2,
                                      channels=channels)
        assert torch.equal(got, want)
    else:
        with pytest.raises((TypeError, ValueError)):
            k1.flocking_sums_block(xr, xc, 0, 0, CR, CR2, channels=channels)


def test_wrapper_rejects_mixed_float_types():
    x = torch.from_numpy(_swarms(2, 16, seed=5))
    with pytest.raises(TypeError, match="float64"):
        k1.flocking_sums_block(x, x.double(), 0, 0, CR, CR2)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


@pytest.mark.parametrize("channels", ["core", "full"])
@pytest.mark.parametrize("n", [64, 137])
def test_float64_matches_jax_x64(n, channels):
    """The JAX package's CPU path under x64 on the same f64 swarms."""
    x = np.random.RandomState(n).randn(3, n, 4) * 2
    got = k1.flocking_sums_block(torch.from_numpy(x), torch.from_numpy(x), 0, 0, CR, CR2,
                                 channels=channels).numpy()
    with jax.enable_x64(True):
        want = np.asarray(_flocking_sums_xla(jnp.asarray(x), CR, CR2, channels=channels))
    assert got.dtype == np.float64 and want.dtype == np.float64
    np.testing.assert_array_equal(got[..., 8], want[..., 8])
    sums = _sum_channels(channels)
    assert _rel(got[..., sums], want[..., sums]) < X64_TOL
    if channels == "full":
        assert _rel(got[..., 9], want[..., 9]) < X64_TOL
    assert not got[..., 12 if channels == "full" else 9:].any()


def test_offset_view_gives_the_copys_result():
    """A contiguous view that starts 4 bytes into its storage (not 16-byte
    aligned) and a strided view are copied first, on every device."""
    x = torch.from_numpy(_swarms(2, 40, seed=8))
    flat = torch.empty(1 + x.numel())
    flat[1:] = x.reshape(-1)
    offset = flat[1:].view(x.shape)
    wide = torch.zeros(2, 40, 5)
    wide[..., 1:] = x
    strided = wide[..., 1:]
    assert offset.is_contiguous() and offset.data_ptr() % 16 and not strided.is_contiguous()
    want = k1.flocking_sums(x, CR, CR2)
    assert torch.equal(k1.flocking_sums(offset, CR, CR2), want)
    assert torch.equal(k1.flocking_sums(strided, CR, CR2), want)
    assert torch.equal(k1.float4_rows(offset), x) and k1.float4_rows(x) is x


def test_wrapper_raises_on_a_device_other_than_cpu_or_cuda():
    x = torch.empty(2, 16, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k1.flocking_sums_block(x, x, 0, 0, CR, CR2)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x = torch.from_numpy(_swarms(2, 32, seed=6))
    before = k1.launches
    got = k1.flocking_sums(x, CR, CR2)
    assert k1.launches == before
    want = k1.flocking_sums_block_reference(x, x, 0, 0, CR, CR2, "core")
    assert torch.equal(got, want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(3, 1000), (64, 100), (4, 4096)])
def test_kernel_matches_plain_on_the_card(cuda, b, n):
    for channels in ("core", "full"):
        x = torch.from_numpy(_swarms(b, n, seed=n)).to(cuda)
        before = k1.launches
        got = k1.flocking_sums_block(x, x, 0, 0, CR, CR2, channels=channels)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        want = k1.flocking_sums_block_reference(x, x, 0, 0, CR, CR2, channels)
        _assert_k1_close(got.cpu().numpy(), want.cpu().numpy(), channels)


@pytest.mark.cuda
def test_float64_on_the_card_raises_and_offset_views_run(cuda):
    x = torch.from_numpy(_swarms(2, 300, seed=9)).to(cuda)
    with pytest.raises(TypeError, match="float32"):
        k1.flocking_sums(x.double(), CR, CR2)
    flat = torch.empty(1 + x.numel(), device=cuda)
    flat[1:] = x.reshape(-1)
    got = k1.flocking_sums(flat[1:].view(x.shape), CR, CR2)
    assert torch.equal(got, k1.flocking_sums(x, CR, CR2))


@pytest.mark.cuda
@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_kernel_matches_plain_on_edge_cases(cuda, case, cr):
    x = torch.from_numpy(edge_swarms(case, cr)).to(cuda)
    for channels in ("core", "full"):
        got = k1.flocking_sums_block(x, x, 0, 0, cr, cr * cr, channels=channels).cpu().numpy()
        want = k1.flocking_sums_block_reference(x, x, 0, 0, cr, cr * cr, channels).cpu().numpy()
        if case == "coincident pair":
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            np.testing.assert_array_equal(got[..., 8], want[..., 8])
        else:
            _assert_k1_close(got, want, channels)
