"""K7, the coverage step's conflict resolution (``ops.conflicts``): the
wrapper's checks and routing on the host; on the card, the kernel against
the plain fixed point and upstream's two passes, and a collect that reads
the host for none of its steps.

This file imports no JAX, so that the card's tests run where JAX is not
installed: ``python -m pytest --noconftest -o addopts="" -p no:cacheprovider
tests/test_torch_conflicts_kernel.py`` on a machine with an NVIDIA GPU.
"""
import pytest
import torch

import gym_flock_tpu_torch as gft
from gym_flock_tpu_torch.envs import coverage as cov
from gym_flock_tpu_torch.ops import conflicts as k7
from gym_flock_tpu_torch.parallel.train_coverage import collect_coverage_batch
from gym_flock_tpu_torch.utils import profiling
from test_torch_explore_full_reference import CONFLICTS


def two_passes(cur, chosen):
    """Upstream's procedure (gym-flock coverage.py:186-201), batched: robots
    that choose their own node claim it, then robot by robot in index order
    a move onto an id already in the result is refused."""
    out = torch.where(chosen == cur, cur, -1)
    for i in range(cur.shape[1]):
        taken = (out == chosen[:, i:i + 1]).any(dim=1)
        out[:, i] = torch.where(out[:, i] >= 0, out[:, i],
                                torch.where(taken, cur[:, i], chosen[:, i]))
    return out


def draw(b, r, n_nodes, seed, stay=0.3, device="cpu"):
    """``(cur, chosen)`` int32 ids in ``[0, n_nodes)``, a share ``stay`` of
    the robots choosing their own node."""
    g = torch.Generator().manual_seed(seed)
    cur = torch.randint(0, n_nodes, (b, r), generator=g, dtype=torch.int32)
    moves = torch.randint(0, n_nodes, (b, r), generator=g, dtype=torch.int32)
    chosen = torch.where(torch.rand(b, r, generator=g) < stay, cur, moves)
    return cur.to(device), chosen.to(device)


def chains(r, reversed_order, head_stays):
    """One world whose robots form a chain, each choosing the next one's
    node, in increasing index order along the chain or in decreasing."""
    cur = torch.arange(1, r + 1, dtype=torch.int32)
    chosen = cur + 1
    if head_stays:
        chosen[-1] = cur[-1]
    if reversed_order:
        cur, chosen = cur.flip(0), chosen.flip(0)
    return cur[None].contiguous(), chosen[None].contiguous()


# ------------------------------------------------------------------ host


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    cur, chosen = draw(3, 5, 8, seed=0)
    bad = [
        ((cur.long(), chosen.long()), TypeError, "int32"),
        ((cur.float(), chosen), TypeError, "int32"),
        ((cur[0], chosen[0]), ValueError, r"\[B, R\]"),
        ((cur[None], chosen[None]), ValueError, r"\[B, R\]"),
        ((cur.t(), chosen.t()), ValueError, "contiguous"),
        ((cur, chosen[:2]), ValueError, "differ in shape"),
        ((cur.tolist(), chosen), TypeError, "torch.Tensor"),
    ]
    wide = torch.zeros(2, k7.MAX_ROBOTS + 1, dtype=torch.int32)
    bad.append(((wide, wide), ValueError, f"at most {k7.MAX_ROBOTS}"))
    meta = torch.empty(3, 5, dtype=torch.int32, device="meta")
    bad.append(((meta, meta), ValueError, "cpu or cuda"))
    before = k7.launches
    for args, error, match in bad:
        with pytest.raises(error, match=match):
            k7.resolve_conflicts(*args)
    assert k7.launches == before


@pytest.mark.parametrize("r,n_nodes", [(1, 1), (2, 2), (6, 3), (33, 20), (100, 30)])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(r, n_nodes):
    cur, chosen = draw(16, r, n_nodes, seed=r)
    before = k7.launches
    got = k7.resolve_conflicts(cur, chosen)
    want, _ = k7.resolve_conflicts_reference(cur, chosen)
    assert got.dtype == torch.int32
    assert torch.equal(got, want) and torch.equal(got, two_passes(cur, chosen))
    assert k7.launches == before


def test_the_cpu_route_keeps_the_fixed_points_rounds_and_integer_type():
    cur, chosen = (t.long() for t in draw(8, 40, 12, seed=5))
    syncs = profiling.syncs
    got, rounds = cov._resolve_conflicts(cur, chosen, True)
    assert got.dtype == torch.int64 and torch.equal(got, two_passes(cur, chosen))
    assert rounds >= 1 and profiling.syncs - syncs == rounds + 1


def test_the_route_hands_any_other_device_to_the_wrapper():
    meta = torch.empty(3, 5, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        cov._resolve_conflicts(meta, meta, True)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_without_collision_checks_chosen_comes_back_with_no_rounds(dtype):
    cur, chosen = (t.to(dtype) for t in draw(4, 10, 3, seed=6))
    before = k7.launches
    got, rounds = cov._resolve_conflicts(cur, chosen, False)
    assert got is chosen and rounds == 0
    assert k7.launches == before


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def explore(tmp_path_factory):
    """ExploreFullEnv-v0 (R=100) on the card, on a procedural map; its bank
    cached in a temporary directory."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(cov.CACHE_ENV, str(tmp_path_factory.mktemp("banks")))
        env, params = gft.make("ExploreFullEnv-v0", device="cuda", real_map=False)
    return env, params


def hold(cur, chosen):
    """The kernel's result, held to the plain fixed point and to the two
    passes on the same inputs; one launch."""
    before = k7.launches
    got = k7.resolve_conflicts(cur, chosen)
    torch.cuda.synchronize()
    assert k7.launches == before + 1
    assert got.dtype == torch.int32 and got.device == cur.device
    want, _ = k7.resolve_conflicts_reference(cur, chosen)
    assert torch.equal(got, want)
    assert torch.equal(got, two_passes(cur, chosen))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONFLICTS))
def test_kernel_resolves_the_hand_made_cases(cuda, case):
    cur, chosen, want = (torch.tensor(x, dtype=torch.int32, device=cuda)
                         for x in CONFLICTS[case])
    assert torch.equal(hold(cur, chosen), want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 512])
@pytest.mark.parametrize("r", [1, 2, 31, 32, 33, 100, 1024])
def test_kernel_matches_plain_on_random_batches(cuda, r, b):
    cur, chosen = draw(b, r, max(2, r // 2), seed=r * 1000 + b, device=cuda)
    hold(cur, chosen)


@pytest.mark.cuda
@pytest.mark.parametrize("r,n_nodes", [(2, 1), (32, 2), (100, 2), (100, 3), (1024, 4)])
def test_kernel_matches_plain_on_dense_collisions(cuda, r, n_nodes):
    for stay in (0.0, 0.5):
        hold(*draw(64, r, n_nodes, seed=r + n_nodes, stay=stay, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [3, 33, 100, 1024])
def test_kernel_matches_plain_on_chains_in_both_index_orders(cuda, r):
    for reversed_order in (False, True):
        for head_stays in (False, True):
            cur, chosen = chains(r, reversed_order, head_stays)
            got = hold(cur.to(cuda), chosen.to(cuda)).cpu()
            # a moving head: every robot moves (the result holds no current
            # node); a staying head: in decreasing order each robot finds
            # the next one's stay and stays, in increasing order only the
            # robot behind the head does
            want = chosen.clone()
            if head_stays and reversed_order:
                want = cur
            elif head_stays:
                want[:, -2:] = cur[:, -2:]
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_neighbour_tables_choices(explore):
    """Every robot's choice read from the bank's self-padded neighbour
    table at reset states and after steps, as ``step_env`` reads it."""
    env, params = explore
    gen = torch.Generator(device="cuda").manual_seed(11)
    state, _ = env.reset_env(gen, params, 256)
    table = params.bank["neighbor_table"]
    pads = 0
    for _ in range(4):
        nbr = table[state.graph.long()[:, None], state.robot_loc.long()]
        pads += int((nbr == state.robot_loc[..., None]).sum())
        for a in range(params.n_actions):
            hold(state.robot_loc, nbr[..., a].contiguous())
        action = torch.randint(0, params.n_actions, state.robot_loc.shape, generator=gen,
                               device="cuda")
        state = env.step_env(gen, state, action, params)[0]
    assert pads > 0  # the self-pads were among the choices


@pytest.mark.cuda
def test_the_card_route_casts_and_counts_no_rounds(cuda):
    cur, chosen = (t.long() for t in draw(16, 100, 40, seed=9, device=cuda))
    before = k7.launches
    got, rounds = cov._resolve_conflicts(cur, chosen, True)
    assert rounds == 0 and k7.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got.long(), two_passes(cur, chosen))


@pytest.mark.cuda
def test_a_collect_on_the_card_reads_the_host_for_no_step(explore):
    env, params = explore
    steps = 3
    gen = torch.Generator(device="cuda").manual_seed(4)
    collect_coverage_batch(env, params, gen, 8, steps)  # warm-up
    torch.cuda.synchronize()
    syncs, launches, rounds = profiling.syncs, k7.launches, env.conflict_rounds
    batch = collect_coverage_batch(env, params, gen, 8, steps)
    torch.cuda.synchronize()
    assert profiling.syncs == syncs
    assert k7.launches - launches == steps
    assert env.conflict_rounds == rounds == 0
    assert batch["label"].shape[0] == 8 * steps
