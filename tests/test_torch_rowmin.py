"""K5 (the greedy expert's row gather + packed min) in the PyTorch port
against the JAX package's ``_rowmin_xla`` and its Pallas kernel in interpret
mode on the CPU, on the cases of tests/test_pallas_kernels.py.

Tolerance: none.  Every value is an integer below 2^24, exact in f32, so
the packed minima must be equal bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gym_flock_tpu.ops.rowmin import _rowmin_pallas, _rowmin_xla
from gym_flock_tpu.ops.rowmin import pad_cost_rows as jax_pad_cost_rows
from gym_flock_tpu_torch.ops import rowmin as k5

torch.set_num_threads(2)


def _case(b, r, t, g, seed=7):
    """Costs 0..19 with 10% unreachable (1024), random rows, blocked at
    density 0.6, env 0 fully blocked."""
    rng = np.random.RandomState(seed)
    mm = rng.randint(0, 20, size=(g, t, t)).astype(np.float32)
    mm[rng.rand(g, t, t) < 0.1] = 1024.0
    rowidx = rng.randint(0, g * t, size=(b, r)).astype(np.int32)
    blocked = rng.rand(b, t) < 0.6
    blocked[0] = True
    return mm, rowidx, blocked


def _port(mm, rowidx, blocked, device="cpu"):
    return k5.packed_greedy_min(
        torch.from_numpy(rowidx).to(device),
        torch.from_numpy(blocked).to(device),
        k5.pad_cost_rows(torch.from_numpy(mm).to(device)),
    )


@pytest.mark.parametrize("b,r,t,g", [(3, 5, 137, 2), (2, 33, 300, 1), (4, 100, 260, 1)])
def test_plain_matches_jax_exactly(b, r, t, g):
    mm, rowidx, blocked = _case(b, r, t, g)
    cost_pad = jnp.asarray(jax_pad_cost_rows(mm), jnp.bfloat16)
    ri, bl = jnp.asarray(rowidx, jnp.int32), jnp.asarray(blocked, jnp.bool_)
    want = np.asarray(jax.vmap(_rowmin_xla, in_axes=(0, 0, None))(ri, bl, cost_pad))
    pallas = np.asarray(_rowmin_pallas(ri, bl, cost_pad, interpret=True))
    got = _port(mm, rowidx, blocked).numpy()
    assert got.dtype == np.float32 and got.shape == (b, r)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    # the fully blocked env: every robot packs 1024 at index 0 (unreachable)
    np.testing.assert_array_equal(got[0], np.full(r, 1024.0 * 8192.0, np.float32))


@pytest.mark.parametrize("t", [1, 63, 64, 65, 300])
def test_pad_cost_rows_pads_with_1024(t):
    rng = np.random.RandomState(t)
    mm = rng.randint(0, 257, size=(2, t, t)).astype(np.float32)
    out = k5.pad_cost_rows(torch.from_numpy(mm))
    tp = -(-t // 64) * 64
    assert out.dtype == torch.bfloat16 and out.shape == (2 * t, tp)
    np.testing.assert_array_equal(out[:, :t].float().numpy(), mm.reshape(2 * t, t))
    assert bool((out[:, t:] == 1024.0).all())
    # the JAX operand holds the same rows, folded and padded to 128 columns
    folded = np.asarray(jax_pad_cost_rows(mm)).reshape(2 * t, -1)
    np.testing.assert_array_equal(out[:, :t].float().numpy(), folded[:, :t])


def _bad_inputs():
    mm, rowidx, blocked = _case(2, 4, 70, 1)
    ri, bl = torch.from_numpy(rowidx), torch.from_numpy(blocked)
    cost = k5.pad_cost_rows(torch.from_numpy(mm))
    return {
        "int64_rowidx": (ri.long(), bl, cost),
        "float_blocked": (ri, bl.float(), cost),
        "f32_cost": (ri, bl, cost.float()),
        "non_contiguous_rowidx": (ri.t().contiguous().t(), bl, cost),
        "non_contiguous_blocked": (ri, torch.from_numpy(np.asfortranarray(blocked)), cost),
        "non_contiguous_cost": (ri, bl, cost[:, :64]),
        "unpadded_cost": (ri, bl, cost[:, :70].contiguous()),
        "batch_mismatch": (ri[:1].contiguous(), bl, cost),
        "unbatched": (ri[0], bl[0], cost),
    }


@pytest.mark.parametrize("name", sorted(_bad_inputs()))
def test_wrapper_rejects_bad_inputs(name):
    with pytest.raises((TypeError, ValueError)):
        k5.packed_greedy_min(*_bad_inputs()[name])


def test_wrapper_raises_on_a_device_other_than_cpu_or_cuda():
    ri = torch.empty(2, 4, dtype=torch.int32, device="meta")
    bl = torch.empty(2, 70, dtype=torch.bool, device="meta")
    cost = torch.empty(70, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        k5.packed_greedy_min(ri, bl, cost)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    mm, rowidx, blocked = _case(3, 6, 100, 2)
    args = (torch.from_numpy(rowidx), torch.from_numpy(blocked),
            k5.pad_cost_rows(torch.from_numpy(mm)))
    before = k5.launches
    got = k5.packed_greedy_min(*args)
    assert k5.launches == before
    assert torch.equal(got, k5.packed_greedy_min_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,t,g", [(3, 33, 300, 2), (64, 100, 1400, 1), (512, 6, 494, 8)])
def test_kernel_matches_plain_on_the_card(b, r, t, g):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mm, rowidx, blocked = _case(b, r, t, g)
    before = k5.launches
    got = _port(mm, rowidx, blocked, "cuda")
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    want = _port(mm, rowidx, blocked)
    assert torch.equal(got.cpu(), want)
