"""K8, the fused flocking rollout's step tail (``ops.step_tail``): the
wrapper's checks and routing, and the rollout's hook on the host; on the
card, the kernel against its plain version.

On the card x' and u must equal the plain version's bit for bit (the
kernel mirrors PyTorch's f32 sequence, with no FMA contraction and the
divide by the host scalar as PyTorch's multiply by its f32 reciprocal); the
reward must lie within ``chip_smoke.STEP_TAIL_REWARD_TOL`` of 1 + the
swarm's mean squared velocity (``torch.var`` sums the velocities in f32,
the kernel their deviations in f64, in another order).

This file imports no JAX, so that the card's tests run where JAX is not
installed: ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider
tests/test_torch_step_tail.py`` on a machine with an NVIDIA GPU.
"""
import pytest
import torch

import gym_flock_tpu_torch as gft
from chip_smoke import STEP_TAIL_SOURCES, hold_step_tail, run_step_tail, step_tail_sums
from gym_flock_tpu_torch.envs import flocking
from gym_flock_tpu_torch.ops import dense_flocking as k6
from gym_flock_tpu_torch.ops import step_tail as k8
from gym_flock_tpu_torch.utils import profiling

torch.set_num_threads(2)

B = 3
STEPS = 4
# the rollout's envs at small sizes; the sparse env's N is a multiple of 128
ENVS = {"FlockingRelative-v0": 24, "FlockingLeader-v0": 24, "FlockingObstacle-v0": 24,
        "FlockingTwoFlocks-v0": 30, "Flocking-v0": 24, "FlockingLarge-v0": 64,
        "FlockingSparse-v0": 128}


def swarms(b, n, seed, dtype=torch.float32):
    """Reset-like draws: positions over a disk, velocities up to +-10."""
    g = torch.Generator().manual_seed(seed)
    x = flocking.FlockingRelativeEnv()._draw(g, flocking.FlockingParams(n_agents=n), b)
    return x.to(dtype)


def args(x, seed=1):
    """``(x, s_gx, s_gy, s_dvx, s_dvy)``: x with sums of the size of real
    ones, some large enough to clamp."""
    g = torch.Generator().manual_seed(seed)
    b, n, _ = x.shape
    sums = [20.0 * torch.randn(b, n, generator=g, dtype=x.dtype) for _ in range(4)]
    return (x, *sums)


def slots(x, steps=3):
    b, n, _ = x.shape
    return (torch.full((b, steps, n, 2), 7.0, dtype=x.dtype),
            torch.full((b, steps), 7.0, dtype=x.dtype))


def todays_rollout(env, state, params, n_steps, centralized, generator=None):
    """The rollout as it ran before K8: the action hook, the integration
    hook and the reward as separate steps after each pass; ``traj`` also
    keeps each step's state under ``x``."""
    x = state.x
    carry = env._fused_carry_init(x, params)
    (_, _, *sums), carry = env._fused_pass_carry(x, params, centralized, carry)
    keep = {"x": [], "u": [], "values": [], "network": [], "reward": []}
    for _ in range(n_steps):
        u = env._expert_action(*sums, params)
        x = env._rollout_integrate(x, u, params, generator)
        (values, network, *sums), carry = env._fused_pass_carry(x, params, centralized, carry)
        for k, v in (("x", x), ("u", u), ("values", values), ("network", network),
                     ("reward", flocking._instant_cost(x))):
            keep[k].append(v)
    return x, {k: torch.stack(v, dim=1) for k, v in keep.items()}


# ------------------------------------------------------------------ host


def bad_calls():
    x, *sums = args(swarms(2, 5, seed=0))
    u, r = slots(x)
    good = dict(x=x, s_gx=sums[0], s_gy=sums[1], s_dvx=sums[2], s_dvy=sums[3], mask=None,
                u_out=u[:, 0], reward_out=r[:, 0])
    yield "x of rank 2", dict(good, x=x[0]), ValueError, "x must have shape"
    yield "x rows of 3", dict(good, x=x[..., :3]), ValueError, "x must have shape"
    yield "x of float16", dict(good, x=x.half()), TypeError, "x must be float32"
    yield "x of int32", dict(good, x=x.int()), TypeError, "x must be float32"
    yield "a sum of rank 3", dict(good, s_gy=sums[1][..., None]), ValueError, "s_gy must have"
    yield "a sum too short", dict(good, s_dvx=sums[2][:, :4]), ValueError, "s_dvx must have"
    yield "a sum of float64", dict(good, s_dvy=sums[3].double()), TypeError, "s_dvy must be"
    yield "a sum not a tensor", dict(good, s_gx=1.0), TypeError, "s_gx must be a torch.Tensor"
    yield "a mask too short", dict(good, mask=torch.ones(4)), ValueError, "mask must have"
    yield "a mask too long", dict(good, mask=torch.ones(6)), ValueError, "mask must have"
    yield "a mask of bool", dict(good, mask=torch.ones(5, dtype=torch.bool)), TypeError, \
        "mask must be"
    yield "u_out of [B,N]", dict(good, u_out=u[:, 0, :, 0]), ValueError, "u_out must have"
    yield "reward_out of [B,1]", dict(good, reward_out=r[:, :1]), ValueError, \
        "reward_out must have"
    yield "x on another device", dict(good, x=x.to("meta")), TypeError, "s_gx must be"


@pytest.mark.parametrize("what,kw,error,match", list(bad_calls()),
                         ids=[c[0] for c in bad_calls()])
def test_the_wrapper_refuses_what_it_does_not_take(what, kw, error, match):
    before = k8.launches
    with pytest.raises(error, match=match):
        k8.step_tail(kw["x"], kw["s_gx"], kw["s_gy"], kw["s_dvx"], kw["s_dvy"], 10.0, 10.0,
                     0.01, kw["mask"], kw["u_out"], kw["reward_out"])
    assert k8.launches == before


def test_another_device_is_refused_after_the_checks():
    x, *sums = (t.to("meta") for t in args(swarms(2, 5, seed=0)))
    u, r = (t.to("meta") for t in slots(swarms(2, 5, seed=0)))
    with pytest.raises(ValueError, match="cpu or cuda"):
        k8.step_tail(x, *sums, 10.0, 10.0, 0.01, None, u[:, 0], r[:, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("masked", [False, True])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(dtype, masked):
    """Today's composition: ``turner_action``, then ``integrate`` of ``u *
    action_scale`` under the mask, the slot writes and ``instant_cost``."""
    x, *sums = args(swarms(4, 9, seed=2, dtype=dtype))
    mask = (torch.arange(9) >= 2).to(dtype) if masked else None
    scale = 1.0 if masked else 10.0
    u_traj, r_traj = slots(x)
    before = k8.launches
    x_next = k8.step_tail(x, *sums, 10.0, scale, 0.01, mask, u_traj[:, 1], r_traj[:, 1])
    assert k8.launches == before
    u = flocking.k1.turner_action(*sums, 10.0)
    want = flocking._integrate(x, u * scale, 0.01, mask)
    assert x_next.dtype == dtype
    assert torch.equal(x_next, want)
    assert torch.equal(u_traj[:, 1], u)
    assert torch.equal(r_traj[:, 1], flocking._instant_cost(want))
    assert bool((u_traj[:, 0::2] == 7.0).all()) and bool((r_traj[:, 0::2] == 7.0).all())
    assert torch.equal(x_next, k8.step_tail_reference(x, *sums, 10.0, scale, 0.01, mask,
                                                      *(t[:, 1] for t in slots(x))))


def test_the_envs_keep_their_names_for_the_moved_functions():
    assert flocking._integrate is k8.integrate
    assert flocking._instant_cost is k8.instant_cost


@pytest.mark.parametrize("centralized", [True, False])
@pytest.mark.parametrize("env_id", list(ENVS))
def test_the_rollout_equals_todays_sequence(env_id, centralized):
    """Every fused rollout through the tail hook gives tensors equal to the
    action hook, the integration hook and the reward run one after the
    other, as the loop ran them before; one tail a step."""
    env, params = gft.make(env_id, n_agents=ENVS[env_id])
    state, _ = env.reset_env(torch.Generator().manual_seed(5), params, B)
    want_x, want = todays_rollout(env, state, params, STEPS, centralized)
    calls = []
    inner = env._rollout_tail

    def counting(*a):
        calls.append(1)
        return inner(*a)

    env._rollout_tail = counting
    final, traj = env.expert_rollout(state, params, STEPS, centralized)
    assert len(calls) == STEPS
    assert torch.equal(final.x, want_x)
    assert set(traj) == set(want) - {"x"}
    for k in traj:
        assert torch.equal(traj[k], want[k]), k


def test_the_base_hook_is_step_tail_with_the_envs_scale_and_mask(monkeypatch):
    seen = []

    def recording(x, *a):
        seen.append(a)
        return k8.step_tail(x, *a)

    monkeypatch.setattr(flocking, "step_tail", recording)
    for env_id, scale, frozen in (("FlockingRelative-v0", 10.0, 0),
                                  ("FlockingLeader-v0", 1.0, 2),
                                  ("FlockingObstacle-v0", 1.0, 4)):
        env, params = gft.make(env_id, n_agents=24)
        state, _ = env.reset_env(torch.Generator().manual_seed(6), params, B)
        seen.clear()
        env.expert_rollout(state, params, 2)
        assert len(seen) == 2
        for s in seen:
            scalar, action_scale, dt, mask = s[4:8]
            assert (scalar, action_scale, dt) == (params.action_scalar, scale, params.dt)
            if frozen:
                assert torch.equal(mask, (torch.arange(24) >= frozen).float())
            else:
                assert mask is None


def test_the_stochastic_rollout_runs_its_own_path(monkeypatch):
    """A dt a swarm from the generator, the clamp and the scaling: its own
    plain sequence, never the wrapper; equal to today's with the same
    draws."""
    def refuse(*a):
        raise AssertionError("FlockingStochastic-v0's step reached ops.step_tail")

    env, params = gft.make("FlockingStochastic-v0", n_agents=24)
    state, _ = env.reset_env(torch.Generator().manual_seed(7), params, B)
    want_x, want = todays_rollout(env, state, params, STEPS, params.centralized,
                                  torch.Generator().manual_seed(8))
    monkeypatch.setattr(flocking, "step_tail", refuse)
    before = k8.launches
    final, traj = env.expert_rollout(state, params, STEPS,
                                     generator=torch.Generator().manual_seed(8))
    assert k8.launches == before
    assert torch.equal(final.x, want_x)
    for k in traj:
        assert torch.equal(traj[k], want[k]), k


def test_the_chip_smoke_sources_are_the_main_paths_views():
    """``step_tail_sums`` hands K8 the views the rollouts hand it: K1's
    channels (stride 16) and the closed form's contiguous velocity sums;
    the dense env's pass's sums (on the card, K6's interleaved ones)."""
    x = swarms(2, 40, seed=3)
    strides = {src: [t.stride(1) for t in step_tail_sums(x, src)] for src in ("k1",
                                                                           "k1_decentralized")}
    assert strides == {"k1": [16, 16, 1, 1], "k1_decentralized": [16, 16, 16, 16]}
    env, params = gft.make("FlockingRelative-v0", n_agents=40)
    for g, w in zip(step_tail_sums(x, "k6"), env._fused_pass(x, params, True)[2:]):
        assert torch.equal(g, w)


def test_the_reward_hold_reads_a_planted_error():
    x, *sums = args(swarms(3, 20, seed=4))
    want = run_step_tail(k8.step_tail_reference, x, sums, None, 10.0)[:3]
    assert hold_step_tail("same", want, want) == 0.0
    off = want[2].clone()
    off[1] += 1e-3
    with pytest.raises(AssertionError, match="reward off"):
        hold_step_tail("planted", (want[0], want[1], off), want)
    bits = want[1].clone()
    bits[0, 0, 0] = torch.nextafter(bits[0, 0, 0], torch.tensor(100.0))
    with pytest.raises(AssertionError, match="u differs"):
        hold_step_tail("planted", (want[0], bits, want[2]), want)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CARD_SHAPES = ([(8192, 100), (65535, 100), (16, 4096)]
               + [(b, n) for n in (1, 31, 32, 33, 1024) for b in (1, 7)])


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", CARD_SHAPES)
def test_kernel_matches_plain_into_trajectory_slots(cuda, b, n):
    x = swarms(b, n, seed=b + n).to(cuda)
    mask = (torch.arange(n, device=cuda) >= 2).float()
    for source in STEP_TAIL_SOURCES:
        if source == "k6" and n > k6.MAX_AGENTS:
            continue
        sums = step_tail_sums(x, source)
        for m, scale in ((None, 10.0), (mask, 1.0)):
            before = k8.launches
            got = run_step_tail(k8.step_tail, x, sums, m, scale)
            torch.cuda.synchronize()
            assert k8.launches == before + 1
            want = run_step_tail(k8.step_tail_reference, x, sums, m, scale)
            hold_step_tail(f"B={b} N={n} {source} mask={m is not None}", got[:3], want[:3])
            assert bool((got[3][:, 0::2] == 7.0).all()) and bool((got[4][:, 0::2] == 7.0).all())
            del got, want


@pytest.mark.cuda
def test_k6s_sums_take_the_interleaved_load(cuda):
    """K6's sums are one [B,N,4] buffer unbound: element stride 4, the four
    at consecutive addresses, as K8's 16-byte load reads them."""
    sums = step_tail_sums(swarms(3, 40, seed=3).to(cuda), "k6")
    assert [t.stride() for t in sums] == [(160, 4)] * 4
    assert [t.data_ptr() - sums[0].data_ptr() for t in sums] == [0, 4, 8, 12]


@pytest.mark.cuda
def test_kernel_passes_nan_sums_where_the_plain_version_does(cuda):
    """Two coincident agents give K6 NaN sums: NaN actions and states in the
    same places, and the swarm's reward NaN."""
    x = swarms(4, 40, seed=9)
    x[1:3, 1, :2] = x[1:3, 0, :2]
    x = x.to(cuda)
    sums = step_tail_sums(x, "k6")
    got = run_step_tail(k8.step_tail, x, sums, None, 10.0)
    want = run_step_tail(k8.step_tail_reference, x, sums, None, 10.0)
    assert bool(torch.isnan(want[2][1:3]).all()) and not bool(torch.isnan(want[2][0]))
    hold_step_tail("coincident", got[:3], want[:3])


@pytest.mark.cuda
def test_a_state_that_is_not_contiguous_is_copied_and_bad_slots_raise(cuda):
    wide = torch.zeros(4, 50, 5, device=cuda)
    wide[..., 1:] = swarms(4, 50, seed=10).to(cuda)
    x = wide[..., 1:]
    sums = step_tail_sums(x.contiguous(), "k6")
    got = run_step_tail(k8.step_tail, x, sums, None, 10.0)
    want = run_step_tail(k8.step_tail, x.contiguous(), sums, None, 10.0)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    u = torch.empty(4, 2, 50, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="u_out must have contiguous"):
        k8.step_tail(x, *sums, 10.0, 10.0, 0.01, None, u, torch.empty(4, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        k8.step_tail(x.double(), *(s.double() for s in sums), 10.0, 10.0, 0.01, None,
                     u.double(), torch.empty(4, device=cuda, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,n_envs", [("FlockingRelative-v0", 256),
                                           ("FlockingLarge-v0", 2)])
def test_a_fused_rollout_launches_k8_once_a_step_and_matches_todays_sequence(
        cuda, env_id, n_envs):
    """One launch a step; the same trajectory as the plain tail's on the card
    (x', u and so every pass bit for bit, the reward within its tolerance);
    no host read (``profiling.syncs``)."""
    env, params = gft.make(env_id)
    state, _ = env.reset_env(torch.Generator(device=cuda).manual_seed(12), params, n_envs)
    want_x, want = todays_rollout(env, state, params, 3, params.centralized)
    before, syncs = k8.launches, profiling.syncs
    final, traj = env.expert_rollout(state, params, 3)
    torch.cuda.synchronize()
    assert k8.launches == before + 3
    assert profiling.syncs == syncs
    assert torch.equal(final.x, want_x)
    for k in ("u", "values", "network"):
        assert torch.equal(traj[k], want[k]), k
    for t in range(3):
        x_t = want["x"][:, t]
        hold_step_tail(f"{env_id} step {t}", (x_t, traj["u"][:, t], traj["reward"][:, t]),
                       (x_t, want["u"][:, t], want["reward"][:, t]))
