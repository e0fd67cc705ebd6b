"""K6, the dense flocking pass (``ops.dense_flocking``): the routing of
``dense_pass`` and the output views on the host; on the card, the kernel
against its plain version.

On the card the network, and so the adjacency, must equal the plain
version's bit for bit (NaN in the same places where two agents coincide);
each of the sums must lie within 1e-5 of the plain version's, relative to
the summed magnitudes of its terms (the plain version sums f32 terms in
f32; the kernel sums K1's f32 terms in f64, the gradient in K1's form).

This file imports no JAX, so that the card's tests run where JAX is not
installed: ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider
tests/test_torch_dense_flocking.py`` on a machine with an NVIDIA GPU.
"""
import math

import numpy as np
import pytest
import torch

import gym_flock_tpu_torch as gft
from chip_smoke import dense_pass_scales, hold_dense_pass
from gym_flock_tpu_torch.ops import dense_flocking as k6
from gym_flock_tpu_torch.ops.flocking_sums import flocking_sums_block_reference

CR = 0.9
CR2 = CR * CR


def swarms(b, n, seed):
    """FlockingRelative's reset distribution without its rejection test:
    positions uniform over the disk of radius (N^(1/2))^(1/2), velocities in
    [-5, 5] plus a per-swarm bias."""
    rng = np.random.RandomState(seed)
    length = np.sqrt(rng.uniform(0.0, math.sqrt(n), (b, n)))
    angle = rng.uniform(0.0, 2.0 * math.pi, (b, n))
    v = rng.uniform(-5.0, 5.0, (b, n, 2)) + rng.uniform(-5.0, 5.0, (b, 1, 2))
    x = np.concatenate([(length * np.cos(angle))[..., None], (length * np.sin(angle))[..., None],
                        v], axis=-1)
    return torch.from_numpy(x.astype(np.float32))


def hard_swarms(case, n=40, seed=5):
    """``"lonely"``: every agent 2 apart from every other, no neighbours;
    ``"coincident"``: agents 0/1 and 5/6 at the same position."""
    x = swarms(2, n, seed)
    if case == "lonely":
        x[..., 0] = 2.0 * torch.arange(n, dtype=torch.float32)
        x[..., 1] = 0.0
    else:
        x[:, 1, :2] = x[:, 0, :2]
        x[:, 6, :2] = x[:, 5, :2]
    return x


def assert_pass_close(got, want, x, cr, cr2, centralized, obstacle_mask=None):
    """``got``/``want``: ``(values, network, s_gx, s_gy, s_dvx, s_dvy)``;
    ``values`` and ``network`` may be ``None`` in both."""
    scales = dense_pass_scales(x, cr, cr2, centralized, obstacle_mask)
    hold_dense_pass("K6", got, want, scales if want[0] is not None else scales[..., 6:])


# ------------------------------------------------------------------ host


def test_cpu_float32_float64_and_an_obstacle_mask_take_the_plain_version():
    x = swarms(3, 20, seed=1)
    mask = torch.arange(20) < 4
    before = k6.launches
    for xs, m in ((x, None), (x.double(), None), (x, mask)):
        got = k6.dense_pass(xs, CR, CR2, True, True, m)
        want = k6.dense_pass_reference(xs, CR, CR2, True, True, m)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert k6.launches == before


@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("centralized", [True, False])
def test_the_kernels_terms_and_sums_lie_within_the_tolerance_of_the_plain_version(
        centralized, cr):
    """The kernel sums K1's f32 terms in f64 (its gradient 2 inv (1 - inv) d,
    not the plain version's -2 d inv^2 + 2 d inv), the closed form's total in
    f64: K1's plain version forms the same terms and sums, so it stands in
    for the kernel here."""
    x = torch.cat([swarms(16, 100, seed=9), hard_swarms("coincident", n=100)])
    s = flocking_sums_block_reference(x, x, 0, 0, cr, cr * cr, "full")
    if centralized:
        n = x.shape[1]
        total = x[..., 2:4].double().sum(dim=1, keepdim=True).float()
        dv = n * x[..., 2:4] - total
        got = (s[..., 0:6], None, s[..., 6], s[..., 7], dv[..., 0], dv[..., 1])
    else:
        got = (s[..., 0:6], None, s[..., 10], s[..., 11], s[..., 0], s[..., 3])
    want = k6.dense_pass_reference(x, cr, cr * cr, centralized)
    assert_pass_close(got, (want[0], None, *want[2:]), x, cr, cr * cr, centralized)


def test_the_kernel_wrapper_raises_on_the_host():
    with pytest.raises(TypeError, match="CUDA"):
        k6.dense_pass_kernel(swarms(1, 8, seed=2), CR, CR2)


@pytest.mark.parametrize("centralized", [True, False])
@pytest.mark.parametrize("mean_pooling", [True, False])
def test_plain_version_writes_into_strided_slots_and_skips_outputs_left_out(
        centralized, mean_pooling):
    b, n, steps = 3, 24, 4
    x = swarms(b, n, seed=3)
    want = k6.dense_pass_reference(x, CR, CR2, centralized, mean_pooling)
    values = torch.full((b, steps, n, 6), 7.0)
    network = torch.full((b, steps, n, n), 7.0)
    slots = (values[:, 2], network[:, 2])
    got = k6.dense_pass(x, CR, CR2, centralized, mean_pooling, out=slots)
    assert got[0] is slots[0] and got[1] is slots[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    others = [t for t in range(steps) if t != 2]
    assert bool((values[:, others] == 7.0).all()) and bool((network[:, others] == 7.0).all())
    sums_only = k6.dense_pass(x, CR, CR2, centralized, mean_pooling, out=(None, None))
    assert sums_only[:2] == (None, None)
    for g, w in zip(sums_only[2:], want[2:]):
        assert torch.equal(g, w)


def test_the_env_pass_is_dense_pass_with_the_params():
    env, params = gft.make("FlockingRelative-v0", n_agents=30)
    x = swarms(2, 30, seed=4)
    for centralized in (True, False):
        got = env._fused_pass(x, params, centralized)
        want = k6.dense_pass_reference(x, params.comm_radius, params.comm_radius2, centralized,
                                       params.mean_pooling)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("env_id,writes", [("FlockingRelative-v0", True),
                                           ("FlockingObstacle-v0", True),
                                           ("Flocking-v0", False),
                                           ("FlockingLarge-v0", False)])
def test_the_rollout_hands_each_step_its_trajectory_slots(env_id, writes):
    """The dense pass writes each step's values and network into the
    trajectory's slots and returns them, so the loop copies neither; a pass
    that writes into no view (the absolute and large envs) returns its own
    outputs, which the loop copies.  Either way the trajectory equals the
    passes' outputs at the rollout's states."""
    env, params = gft.make(env_id, n_agents=32)
    state = env.init_state(swarms(2, 32, seed=8), params)
    seen = []
    inner = env._fused_pass_carry

    def recording(x, p, centralized, carry, out=None):
        result, carry = inner(x, p, centralized, carry, out)
        seen.append((x, out, result[:2]))
        return result, carry

    env._fused_pass_carry = recording
    _, traj = env.expert_rollout(state, params, 3)
    assert seen[0][1] == (None, None)
    if writes:
        assert seen[0][2] == (None, None)
    for t, (x, out, (values, network)) in enumerate(seen[1:]):
        assert (values is out[0] and network is out[1]) == writes
        assert out[0].data_ptr() == traj["values"][:, t].data_ptr()
        assert out[1].data_ptr() == traj["network"][:, t].data_ptr()
        want = inner(x, params, params.centralized, None)[0]
        assert torch.equal(traj["values"][:, t], want[0])
        assert torch.equal(traj["network"][:, t], want[1])


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CARD_SHAPES = ([(b, n) for n in (1, 2, 31, 32, 33, 100, 128, k6.MAX_AGENTS) for b in (1, 3)]
               + [(8192, n) for n in (1, 2, 31, 32, 33, 100, 128)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", CARD_SHAPES)
def test_kernel_matches_plain_into_trajectory_slots(cuda, b, n):
    x = swarms(b, n, seed=n).to(cuda)
    for centralized in (True, False):
        want = k6.dense_pass_reference(x, CR, CR2, centralized, True)
        values = torch.full((b, 3, n, 6), 7.0, device=cuda)
        network = torch.full((b, 3, n, n), 7.0, device=cuda)
        slots = (values[:, 1], network[:, 1])
        before = k6.launches
        got = k6.dense_pass(x, CR, CR2, centralized, True, out=slots)
        torch.cuda.synchronize()
        assert k6.launches == before + 1
        assert got[0] is slots[0] and got[1] is slots[1]
        assert_pass_close(got, want, x, CR, CR2, centralized)
        assert bool((values[:, 0::2] == 7.0).all()) and bool((network[:, 0::2] == 7.0).all())
        sums_only = k6.dense_pass(x, CR, CR2, centralized, True, out=(None, None))
        assert sums_only[:2] == (None, None)
        assert_pass_close(sums_only, (None, None, *want[2:]), x, CR, CR2, centralized)
        del want, values, network, got, sums_only


@pytest.mark.cuda
@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", ["lonely", "coincident"])
def test_kernel_matches_plain_on_hard_swarms(cuda, case, cr):
    x = hard_swarms(case).to(cuda)
    for centralized in (True, False):
        for mean_pooling in (True, False):
            got = k6.dense_pass(x, cr, cr * cr, centralized, mean_pooling)
            want = k6.dense_pass_reference(x, cr, cr * cr, centralized, mean_pooling)
            assert_pass_close(got, want, x, cr, cr * cr, centralized)
    if case == "lonely":
        assert not bool(got[1].any())


@pytest.mark.cuda
def test_a_state_that_is_not_contiguous_is_copied(cuda):
    wide = swarms(4, 100 * 5 // 4, seed=6).reshape(4, 100, 5).to(cuda)
    x = wide[..., :4]
    assert not x.is_contiguous()
    got = k6.dense_pass(x, CR, CR2)
    want = k6.dense_pass(x.contiguous(), CR, CR2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1, 1), (3, 31), (3, 33), (8192, 100), (3, k6.MAX_AGENTS)])
def test_kernel_matches_plain_under_an_obstacle_mask(cuda, b, n):
    x = swarms(b, n, seed=n + 1).to(cuda)
    x[:, : min(4, n), 2:4] = 0.0  # obstacles at rest, as FlockingObstacle-v0 holds them
    for mask in (torch.arange(n, device=cuda) < 4, torch.arange(n, device=cuda) % 3 == 1):
        for centralized in (True, False):
            want = k6.dense_pass_reference(x, CR, CR2, centralized, True, mask)
            values = torch.full((b, 2, n, 6), 7.0, device=cuda)
            network = torch.full((b, 2, n, n), 7.0, device=cuda)
            slots = (values[:, 1], network[:, 1])
            before = k6.launches
            got = k6.dense_pass(x, CR, CR2, centralized, True, mask, out=slots)
            torch.cuda.synchronize()
            assert k6.launches == before + 1
            assert_pass_close(got, want, x, CR, CR2, centralized, mask)
            assert bool((values[:, 0] == 7.0).all()) and bool((network[:, 0] == 7.0).all())
            sums_only = k6.dense_pass(x, CR, CR2, centralized, True, mask, out=(None, None))
            for g, w in zip(sums_only[2:], got[2:]):
                assert torch.equal(g, w)


@pytest.mark.cuda
def test_float64_a_large_swarm_and_a_bad_mask_raise_on_the_card(cuda):
    before = k6.launches
    with pytest.raises(TypeError, match="float32"):
        k6.dense_pass(swarms(2, 16, 7).double().to(cuda), CR, CR2)
    with pytest.raises(ValueError, match="N <="):
        k6.dense_pass(swarms(1, k6.MAX_AGENTS + 1, 7).to(cuda), CR, CR2)
    with pytest.raises(ValueError, match="obstacle_mask"):
        k6.dense_pass(swarms(2, 16, 7).to(cuda), CR, CR2, True, True,
                      torch.arange(15, device=cuda) < 4)
    with pytest.raises(TypeError, match="values_out"):
        k6.dense_pass(swarms(2, 16, 7).to(cuda), CR, CR2,
                      out=(torch.empty(2, 16, 6, device=cuda, dtype=torch.float64), None))
    with pytest.raises(ValueError, match="network_out"):
        k6.dense_pass(swarms(2, 16, 7).to(cuda), CR, CR2,
                      out=(None, torch.empty(2, 16, 16, device=cuda).transpose(1, 2)))
    assert k6.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["FlockingRelative-v0", "FlockingLeader-v0",
                                    "FlockingStochastic-v0", "FlockingTwoFlocks-v0",
                                    "FlockingObstacle-v0"])
def test_rollouts_of_the_dense_variants_run_the_kernel_every_step(cuda, env_id):
    """One launch a pass (the one before the loop and one a step), and each
    step's stored network and values the plain version's at the step's
    state."""
    env, params = gft.make(env_id)
    gen = torch.Generator(device=cuda).manual_seed(11)
    state, _ = env.reset_env(gen, params, 16)
    before = k6.launches
    final, traj = env.expert_rollout(state, params, 3, generator=gen)
    torch.cuda.synchronize()
    assert k6.launches == before + 4
    mask = env._obstacle_mask(params, final.x)
    cr, cr2 = params.comm_radius, params.comm_radius2
    want = k6.dense_pass_reference(final.x, cr, cr2, params.centralized, params.mean_pooling,
                                   mask)
    assert torch.equal(traj["network"][:, -1], want[1])
    assert_pass_close((traj["values"][:, -1], None, *want[2:]), (want[0], None, *want[2:]),
                      final.x, cr, cr2, params.centralized, mask)
