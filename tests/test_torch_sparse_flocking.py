"""K3 and the cell-list flocking pipeline of the PyTorch port against the JAX
package's ``ops/sparse_flocking.py`` and ``FlockingSparse-v0``, on the CPU.

Inputs are made with numpy from a seed, as f32; radii are Python floats.
Tolerances: permutations, candidate tables, overflow flags, Verlet states,
acceptance booleans and the degree exactly; every other sum channel
max |port - jax| / (1 + |jax|) < 1e-4, the measure of
tests/test_sparse_flocking.py (the port accumulates in f64, JAX in f32); the
rollouts' ``u``, values and reward the same relative measure.  Where two
coincident agents make sums NaN, the NaN lie in the same places and the
degree is exact.

The CUDA kernel runs its arithmetic only on the listed pairs with r2 < cr2
or not r2 > cr; the premise tests hold the plain version equal, bit for bit
with NaN equal, to the same sums over those pairs only, on the edge-case
swarms of ``chip_smoke.edge_swarms``.
"""
import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import gym_flock_tpu as gft_jax
from chip_smoke import EDGE_CASES, edge_swarms
import gym_flock_tpu_torch as gft
from gym_flock_tpu.ops import sparse_flocking as jsf
from gym_flock_tpu_torch import convert
from gym_flock_tpu_torch.envs import flocking as tfl
from gym_flock_tpu_torch.ops import flocking_sums as k1
from gym_flock_tpu_torch.ops import sparse_flocking as sf
from gym_flock_tpu_torch.ops.flocking_sums import N_OUT

torch.set_num_threads(2)

CR = 0.9
CR2 = CR * CR
SUM_TOL = 1e-4
K_MAX = 16


def uniform_swarms(b, n, seed, density=1.0):
    """Positions uniform over a square at ``density`` agents per unit^2,
    velocities standard normal (the state of bench metric 4)."""
    rng = np.random.RandomState(seed)
    x = np.empty((b, n, 4), np.float32)
    x[..., :2] = rng.uniform(0.0, math.sqrt(n / density), (b, n, 2))
    x[..., 2:] = rng.standard_normal((b, n, 2))
    return x


def normal_swarms(b, n, seed, spread):
    """Standard normal states with positions scaled by ``spread`` (the
    swarms of tests/test_sparse_flocking.py)."""
    x = np.random.RandomState(seed).standard_normal((b, n, 4)).astype(np.float32)
    x[..., :2] *= spread
    return x


def grid_swarms(b, n, seed, spacing=0.45, jitter=0.1):
    """Jittered grids, velocities in [-1, 1].  The default spacing gives
    every agent neighbours and no pair closer than 0.25; spacing 1 is the
    density of bench metric 4 without its near-coincident pairs, whose
    1/r^4 terms cancel in the expert's sums beyond f32's reach."""
    rng = np.random.RandomState(seed)
    side = math.ceil(math.sqrt(n))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    base = spacing * np.stack([gx.ravel(), gy.ravel()], axis=1)[:n]
    x = np.empty((b, n, 4), np.float32)
    x[..., :2] = base + rng.uniform(-jitter, jitter, (b, n, 2))
    x[..., 2:] = rng.uniform(-1.0, 1.0, (b, n, 2))
    return x


STATES = {
    "uniform N=1024": lambda: uniform_swarms(2, 1024, seed=1),
    "normal N=1024": lambda: normal_swarms(3, 1024, seed=2, spread=12.0),
    "normal N=256": lambda: normal_swarms(2, 256, seed=3, spread=4.0),
    "clustered N=512": lambda: normal_swarms(2, 512, seed=4, spread=1.5),
    # bench metric 4's state at its full N, from the numpy seeds of
    # chip_smoke.py's phase 10: seed 3's skin-widened start table overflows
    # k_max=16, seed 10's does not
    "bench N=65536 seed 3": lambda: uniform_swarms(1, 65536, seed=3),
    "bench N=65536 seed 10": lambda: uniform_swarms(1, 65536, seed=10),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def _sum_channels(channels):
    return list(range(8)) + ([10, 11] if channels != "core" else [])


def _assert_sums_close(got, want, channels):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 8], want[..., 8])
    sums = _sum_channels(channels)
    assert _rel(got[..., sums], want[..., sums]) < SUM_TOL
    if channels == "expert":
        assert not np.any(got[..., 9])
    if channels == "full":
        np.testing.assert_array_max_ulp(got[..., 9], want[..., 9], maxulp=1)
    n_used = 9 if channels == "core" else 12
    assert not np.any(got[..., n_used:])


def _sorted(x):
    """The port's sort of numpy states: ``(xs tensor, perm tensor)``."""
    xt = torch.from_numpy(x)
    perm = sf.hilbert_order(xt, CR)
    return sf.permute(xt, perm), perm


def _jax_sorted_table(xs, k_max=K_MAX, skin=0.0):
    table, overflow = jax.vmap(lambda a: jsf.block_pair_table(a, CR, k_max, skin=skin))(
        jnp.asarray(xs)
    )
    return np.asarray(table), np.asarray(overflow)


# ------------------------------------------------------- sort and table


@pytest.mark.parametrize("name", sorted(STATES))
def test_hilbert_order_equals_jax(name):
    x = STATES[name]()
    got = sf.hilbert_order(torch.from_numpy(x), CR)
    want = jax.vmap(lambda a: jsf.hilbert_order(a, CR))(jnp.asarray(x))
    assert got.shape == x.shape[:2]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("skin", [0.0, CR])
@pytest.mark.parametrize("name", ["uniform N=1024", "normal N=1024"])
def test_block_pair_table_equals_jax(name, skin):
    xs, _ = _sorted(STATES[name]())
    table, overflow = sf.block_pair_table(xs, CR, K_MAX, skin=skin)
    want_table, want_overflow = _jax_sorted_table(xs.numpy(), skin=skin)
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), want_table)
    np.testing.assert_array_equal(overflow.numpy(), want_overflow)
    assert (table.numpy() == -1).any()  # the cases are ragged


def test_block_pair_table_overflow_equals_jax():
    """A clustered swarm lists every block: k_max=2 overflows."""
    xs, _ = _sorted(STATES["clustered N=512"]())
    table, overflow = sf.block_pair_table(xs, CR, 2)
    want_table, want_overflow = _jax_sorted_table(xs.numpy(), k_max=2)
    assert overflow.all()
    np.testing.assert_array_equal(table.numpy(), want_table)
    np.testing.assert_array_equal(overflow.numpy(), want_overflow)


@pytest.mark.parametrize("name, overflows", [
    pytest.param(name, overflows, id=name) for name, overflows in [
        ("uniform N=1024", False), ("clustered N=512", False),
        ("bench N=65536 seed 3", True), ("bench N=65536 seed 10", False),
    ]
])
def test_verlet_build_equals_jax(name, overflows):
    x = STATES[name]()
    got = sf.verlet_build(torch.from_numpy(x), CR, CR, k_max=K_MAX)
    want = jax.vmap(lambda a: jsf.verlet_build(a, CR, CR, k_max=K_MAX))(jnp.asarray(x))
    for field in ("perm", "table", "anchor", "overflow"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )
    assert bool(got.overflow.any()) == overflows


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("channels", ["core", "expert"])
def test_plain_k3_matches_pallas_kernel_and_xla(channels):
    """The plain version against the Pallas kernel (interpret mode) and the
    XLA formulation, on the same sorted operands."""
    xs, _ = _sorted(STATES["uniform N=1024"]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX, skin=CR)
    got = sf.sparse_sums_sorted(xs, table, CR, CR2, channels).numpy()
    expert = channels == "expert"
    pallas = jsf._sparse_sums_pallas(
        jnp.asarray(xs.numpy()), jnp.asarray(table.numpy()), CR, CR2,
        interpret=True, expert=expert,
    )
    xla = jax.vmap(lambda a, t: jsf._sparse_sums_sorted(a, t, CR, CR2, expert=expert))(
        jnp.asarray(xs.numpy()), jnp.asarray(table.numpy())
    )
    _assert_sums_close(got, pallas, channels)
    _assert_sums_close(got, xla, channels)


def test_plain_k3_full_adds_the_min_over_listed_pairs():
    """"full" = "expert" plus channel 9, the min r^2 over the listed pairs:
    equal to K1's min wherever that lies within the pruning reach."""
    xs, _ = _sorted(STATES["normal N=1024"]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX)
    full = sf.sparse_sums_sorted(xs, table, CR, CR2, "full")
    expert = sf.sparse_sums_sorted(xs, table, CR, CR2, "expert")
    assert torch.equal(full[..., [c for c in range(16) if c != 9]],
                       expert[..., [c for c in range(16) if c != 9]])
    dense = k1.flocking_sums_block_reference(xs, xs, 0, 0, CR, CR2, "full")
    _assert_sums_close(expert.numpy(), np.where(np.arange(16) == 9, 0.0, dense.numpy()),
                       "expert")
    reach2 = max(CR, math.sqrt(CR)) ** 2
    near = dense[..., 9] <= reach2 * (1 - 1e-6)
    assert near.any() and (~near).any()
    assert torch.equal(full[..., 9][near], dense[..., 9][near])
    assert (full[..., 9][~near] >= dense[..., 9][~near]).all()


def _edge_sorted(case, cr):
    """An edge-case swarm sorted at ``cr`` and its table."""
    x = torch.from_numpy(edge_swarms(case, cr))
    xs = sf.permute(x, sf.hilbert_order(x, cr))
    table, overflow = sf.block_pair_table(xs, cr, K_MAX)
    assert not overflow.any()
    return xs, table


def _equal_nan(a, b):
    """Bit-for-bit equality of two f32 results, NaN equal to NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def _restricted_k3(xs, table, cr, cr2, channels):
    """K1's plain version row by row over only the listed columns within
    reach of the row (r2 < cr2 or not r2 > cr, NaN included), in the table's
    order; the row's own column is kept and masked by id."""
    b, n, _ = xs.shape
    out = torch.zeros(b, n, k1.N_OUT)
    k1_channels = "core" if channels == "core" else "full"
    for s in range(b):
        for i in range(n):
            blocks = [int(j) for j in table[s, i // sf.BLOCK] if j >= 0]
            ids = torch.cat([torch.arange(j * sf.BLOCK, (j + 1) * sf.BLOCK) for j in blocks])
            cols = xs[s, ids]
            d = xs[s, i, :2] - cols[:, :2]
            r2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
            own = ids == i
            keep = (r2 < cr2) | ~(r2 > cr) | own
            at = own[keep].nonzero()
            row_id = int(at[0]) if len(at) else int(keep.sum())  # its own column, or none
            out[s, i] = k1.flocking_sums_block_reference(
                xs[s:s + 1, i:i + 1].contiguous(), cols[None, keep].contiguous(), row_id, 0,
                cr, cr2, k1_channels)[0, 0]
    if channels == "core":
        out[..., 9:] = 0.0
    return out


@pytest.mark.parametrize("channels", ["core", "expert", "full"])
@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_plain_k3_sums_only_the_pairs_within_reach(case, cr, channels):
    """Every listed pair with r2 >= cr2 and r2 > cr adds exact zeros:
    dropping them leaves every channel but the min (9) unchanged, NaN
    included."""
    xs, table = _edge_sorted(case, cr)
    want = sf.sparse_sums_sorted_reference(xs, table, cr, cr * cr, channels)
    got = _restricted_k3(xs, table, cr, cr * cr, channels)
    sums = [c for c in range(N_OUT) if c != 9]
    assert _equal_nan(got[..., sums], want[..., sums])
    assert bool(want.isnan().any()) == (case == "coincident pair")
    assert bool(want[..., :8].nan_to_num().any()) == (case != "none in reach")


@pytest.mark.parametrize("channels", ["core", "expert"])
@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_k3_edge_cases_match_pallas(case, cr, channels):
    xs, table = _edge_sorted(case, cr)
    got = sf.sparse_sums_sorted(xs, table, cr, cr * cr, channels).numpy()
    want = np.asarray(jsf._sparse_sums_pallas(jnp.asarray(xs.numpy()), jnp.asarray(table.numpy()),
                                              cr, cr * cr, interpret=True,
                                              expert=channels == "expert"))
    if case == "coincident pair":
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got[..., 8], want[..., 8])
        assert np.isnan(got).any()
    else:
        _assert_sums_close(got, want, channels)


def test_plain_k3_skips_pad_slots_anywhere():
    """A ragged table with pads first and a width above n_b sums the same."""
    xs, _ = _sorted(STATES["uniform N=1024"]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX)
    ragged = torch.cat([table.flip(-1), torch.full_like(table[..., :3], -1)], dim=-1)
    for channels in ("core", "expert", "full"):
        a = sf.sparse_sums_sorted(xs, table, CR, CR2, channels)
        b = sf.sparse_sums_sorted(xs, ragged.contiguous(), CR, CR2, channels)
        _assert_sums_close(b.numpy(), a.numpy(), channels)


# -------------------------------------------------------------- pipeline


@pytest.mark.parametrize("channels", ["core", "expert"])
@pytest.mark.parametrize("name", ["uniform N=1024", "normal N=1024"])
def test_flocking_sums_sparse_matches_jax_and_dense(name, channels):
    x = STATES[name]()
    got = sf.flocking_sums_sparse(torch.from_numpy(x), CR, CR2, channels=channels)
    want = jsf.flocking_sums_sparse(jnp.asarray(x), CR, CR2, k_max=K_MAX, channels=channels)
    _assert_sums_close(got.numpy(), want, channels)
    xt = torch.from_numpy(x)
    dense = k1.flocking_sums_block_reference(
        xt, xt, 0, 0, CR, CR2, "core" if channels == "core" else "full"
    )
    if channels == "expert":
        dense[..., 9] = 0.0
    _assert_sums_close(got.numpy(), dense.numpy(), channels)


def test_flocking_sums_sparse_rejects_the_dense_vocabulary():
    x = torch.from_numpy(STATES["normal N=256"]())
    with pytest.raises(ValueError, match="core.*expert"):
        sf.flocking_sums_sparse(x, CR, CR2, channels="full")


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of K1's wrapper and of K3's."""
    calls = {"k1": 0, "k3": 0}
    k1_block, k3 = k1.flocking_sums_block, sf.sparse_sums_sorted

    def count_k1(*args, **kwargs):
        calls["k1"] += 1
        return k1_block(*args, **kwargs)

    def count_k3(*args, **kwargs):
        calls["k3"] += 1
        return k3(*args, **kwargs)

    monkeypatch.setattr(k1, "flocking_sums_block", count_k1)
    monkeypatch.setattr(sf, "sparse_sums_sorted", count_k3)
    return calls


@pytest.mark.parametrize("channels", ["core", "expert"])
@pytest.mark.parametrize("name,k_max,overflows", [
    ("clustered N=512", 2, True),
    ("normal N=1024", K_MAX, False),
])
def test_overflow_takes_the_k1_path(routes, name, k_max, overflows, channels):
    x = STATES[name]()
    before = sf.overflow_passes
    got = sf.flocking_sums_sparse(torch.from_numpy(x), CR, CR2, k_max=k_max, channels=channels)
    assert routes == ({"k1": 1, "k3": 0} if overflows else {"k1": 0, "k3": 1})
    assert sf.overflow_passes == before + int(overflows)
    want = jsf.flocking_sums_sparse(jnp.asarray(x), CR, CR2, k_max=k_max, channels=channels)
    _assert_sums_close(got.numpy(), want, channels)


# the three cases of tests/test_sparse_flocking.py (the clustered one with a
# k_max its two blocks overflow) and a grid that the lower threshold accepts
RESET_CASES = {
    "grid": (lambda: grid_swarms(3, 256, seed=11), K_MAX),
    "normal spread 4": (lambda: normal_swarms(3, 256, seed=12, spread=4.0), K_MAX),
    "sparse: low degree": (lambda: normal_swarms(3, 512, seed=13, spread=50.0), K_MAX),
    "clustered: overflow": (lambda: normal_swarms(3, 256, seed=14, spread=0.02), 1),
}


@pytest.mark.parametrize("thresh", [0.1, 0.5])
@pytest.mark.parametrize("name", sorted(RESET_CASES))
def test_sparse_reset_accept_equals_jax(routes, name, thresh):
    maker, k_max = RESET_CASES[name]
    x = maker()
    got = sf.sparse_reset_accept(torch.from_numpy(x), CR, CR2, thresh, k_max=k_max)
    want = jsf.sparse_reset_accept(jnp.asarray(x), CR, CR2, thresh, k_max=k_max)
    assert got.dtype == torch.bool and got.shape == (3,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    overflow = name.startswith("clustered")
    assert routes == ({"k1": 1, "k3": 0} if overflow else {"k1": 0, "k3": 1})
    if name == "grid":
        assert bool(got.all()) if thresh == 0.1 else not bool(got.any())


# ---------------------------------------------------------------- Verlet


def _jax_verlet(x, vstate, skin=CR, channels="core"):
    return jsf.flocking_sums_sparse_verlet(jnp.asarray(x), vstate, CR, CR2, skin,
                                           channels=channels)


def _assert_vstate_equal(got, want):
    for field in ("perm", "table", "anchor", "overflow"):
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), err_msg=field
        )


@pytest.mark.parametrize("channels", ["core", "expert"])
def test_verlet_pass_reuses_the_table_within_slack(channels):
    x0 = STATES["normal N=1024"]()
    step = np.random.RandomState(5).standard_normal(x0.shape[:2] + (2,)).astype(np.float32)
    step *= 0.49 * CR / np.linalg.norm(step, axis=-1, keepdims=True)
    x1 = x0.copy()
    x1[..., :2] += step
    vs0 = sf.verlet_build(torch.from_numpy(x0), CR, CR)
    before = sf.verlet_rebuilds
    got, vs1 = sf.flocking_sums_sparse_verlet(torch.from_numpy(x1), vs0, CR, CR2, CR,
                                              channels=channels)
    assert sf.verlet_rebuilds == before and vs1 is vs0
    jvs0 = jax.vmap(lambda a: jsf.verlet_build(a, CR, CR, k_max=K_MAX))(jnp.asarray(x0))
    want, jvs1 = _jax_verlet(x1, jvs0, channels=channels)
    _assert_sums_close(got.numpy(), want, channels)
    _assert_vstate_equal(vs1, jvs1)
    fresh = sf.flocking_sums_sparse(torch.from_numpy(x1), CR, CR2, channels=channels)
    _assert_sums_close(got.numpy(), fresh.numpy(), channels)


def test_verlet_pass_rebuilds_beyond_slack():
    """One agent of one swarm past skin/2 rebuilds every swarm."""
    x0 = STATES["normal N=1024"]()
    x1 = x0.copy()
    x1[0, 0, 0] += 0.51 * CR
    vs0 = sf.verlet_build(torch.from_numpy(x0), CR, CR)
    before = sf.verlet_rebuilds
    got, vs1 = sf.flocking_sums_sparse_verlet(torch.from_numpy(x1), vs0, CR, CR2, CR)
    assert sf.verlet_rebuilds == before + 1
    np.testing.assert_array_equal(vs1.anchor.numpy(), x1[..., :2])
    jvs0 = jax.vmap(lambda a: jsf.verlet_build(a, CR, CR, k_max=K_MAX))(jnp.asarray(x0))
    want, jvs1 = _jax_verlet(x1, jvs0)
    _assert_sums_close(got.numpy(), want, "core")
    _assert_vstate_equal(vs1, jvs1)


def test_verlet_overflow_takes_the_k1_path(routes):
    x = STATES["clustered N=512"]()
    vs = sf.verlet_build(torch.from_numpy(x), CR, CR, k_max=2)
    assert vs.overflow.all()
    got, _ = sf.flocking_sums_sparse_verlet(torch.from_numpy(x), vs, CR, CR2, CR)
    assert routes == {"k1": 1, "k3": 0}
    jvs = jax.vmap(lambda a: jsf.verlet_build(a, CR, CR, k_max=2))(jnp.asarray(x))
    want, _ = _jax_verlet(x, jvs)
    _assert_sums_close(got.numpy(), want, "core")


# ------------------------------------------------------------ the slice


N_ENV, B_ENV, STEPS = 1024, 2, 12


def _both_envs(x, **overrides):
    jenv, jp = gft_jax.make("FlockingSparse-v0", n_agents=x.shape[1], **overrides)
    tenv, tp = gft.make("FlockingSparse-v0", n_agents=x.shape[1], **overrides)
    assert tp == convert.params_from_jax(jp)
    jstate = jax.vmap(lambda a: jenv.init_state(a, jp))(jnp.asarray(x))
    return (jenv, jp, jstate), (tenv, tp, convert.state_from_numpy(x, tp, "cpu"))


def _assert_traj_close(got, want):
    np.testing.assert_array_equal(np.asarray(got["network"]), np.asarray(want["network"]))
    for key in ("u", "values", "reward"):
        assert _rel(got[key], want[key]) < SUM_TOL, key


@pytest.mark.parametrize("dt,centralized,rebuilds", [
    (0.01, True, 0), (0.01, False, 0), (0.1, False, 3),
])
def test_sparse_expert_rollout_matches_jax(dt, centralized, rebuilds):
    """The Verlet rollout against JAX's, free-running for 12 steps: dt=0.01
    reuses the first table throughout, dt=0.1 rebuilds it.  Also against
    the port's every-step rebuild (verlet_skin=0)."""
    x = grid_swarms(B_ENV, N_ENV, seed=30, spacing=1.0, jitter=0.25)
    (jenv, jp, jstate), (tenv, tp, tstate) = _both_envs(x, dt=dt)
    before = sf.verlet_rebuilds
    final, traj = tenv.expert_rollout(tstate, tp, STEPS, centralized=centralized)
    assert sf.verlet_rebuilds - before == rebuilds
    jfinal, jtraj = jax.jit(jax.vmap(
        lambda s: jenv.expert_rollout(s, jp, STEPS, centralized=centralized)
    ))(jstate)
    assert traj["u"].shape == (B_ENV, STEPS, N_ENV, 2)
    assert traj["network"].shape == (B_ENV, STEPS, N_ENV)
    _assert_traj_close({k: v.numpy() for k, v in traj.items()}, jtraj)
    assert _rel(final.x.numpy(), jfinal.x) < SUM_TOL
    _, base = tenv.expert_rollout(tstate, dataclasses.replace(tp, verlet_skin=0.0), STEPS,
                                  centralized=centralized)
    _assert_traj_close({k: v.numpy() for k, v in traj.items()},
                       {k: v.numpy() for k, v in base.items()})


@pytest.mark.parametrize("centralized", [True, False])
def test_sparse_verlet_rollout_at_dt_06_is_step_locked_to_jax(centralized):
    """dt=0.6 rebuilds the table every step.  Free-running, this closed loop
    amplifies the 1-ulp differences of the Euler step (XLA contracts it into
    FMAs, PyTorch rounds each operation) past the 1e-4 bound within a step
    or two, so each step of the port's rollout is held to JAX's Verlet pass
    threaded along the port's own states: the same Verlet state, degree,
    values and next action."""
    dt = 0.6
    x = grid_swarms(B_ENV, N_ENV, seed=30, spacing=1.0, jitter=0.25)
    (jenv, jp, _), (tenv, tp, tstate) = _both_envs(x, dt=dt)
    channels = "core" if centralized else "expert"
    before = sf.verlet_rebuilds
    _, traj = tenv.expert_rollout(tstate, tp, STEPS, centralized=centralized)
    assert sf.verlet_rebuilds - before == STEPS
    _, base = tenv.expert_rollout(tstate, dataclasses.replace(tp, verlet_skin=0.0), STEPS,
                                  centralized=centralized)
    _assert_traj_close({k: v.numpy() for k, v in traj.items()},
                       {k: v.numpy() for k, v in base.items()})

    def jax_pass(xt, jvs):
        xj = jnp.asarray(xt.numpy())
        s, jvs = jsf.flocking_sums_sparse_verlet(xj, jvs, CR, CR2, CR, channels=channels)
        _, _, gx, gy, dvx, dvy = jax.vmap(
            lambda a, b: jenv._unpack_sums(a, b, centralized))(s, xj)
        u = jnp.clip(jnp.stack((-gx - dvx, -dvy - gy), -1), -10.0, 10.0) / jp.action_scalar
        return np.asarray(s), np.asarray(u), jvs

    xt = tstate.x
    jvs = jax.vmap(lambda a: jsf.verlet_build(a, CR, CR, k_max=K_MAX))(jnp.asarray(xt.numpy()))
    tvs = sf.verlet_build(xt, CR, CR)
    _, u, jvs = jax_pass(xt, jvs)
    assert _rel(traj["u"][:, 0].numpy(), u) < SUM_TOL
    for t in range(STEPS):
        xt = tfl._integrate(xt, traj["u"][:, t] * tp.action_scalar, dt)
        s, u, jvs = jax_pass(xt, jvs)
        _, tvs = sf.flocking_sums_sparse_verlet(xt, tvs, CR, CR2, CR, channels=channels)
        _assert_vstate_equal(tvs, jvs)
        np.testing.assert_array_equal(traj["network"][:, t].numpy(), s[..., 8])
        assert _rel(traj["values"][:, t].numpy(), s[..., :6]) < SUM_TOL
        if t + 1 < STEPS:
            assert _rel(traj["u"][:, t + 1].numpy(), u) < SUM_TOL


def test_decentralized_rollout_without_verlet_uses_the_expert_channels():
    """The inherited fused pass asks ``_sums`` for "expert" (the dense
    kernels' "full" would raise in the sparse pipeline)."""
    x = grid_swarms(B_ENV, 256, seed=31, spacing=1.0, jitter=0.25)
    (jenv, jp, jstate), (tenv, tp, tstate) = _both_envs(x, verlet_skin=0.0)
    _, traj = tenv.expert_rollout(tstate, tp, 4, centralized=False)
    _, jtraj = jax.jit(jax.vmap(
        lambda s: jenv.expert_rollout(s, jp, 4, centralized=False)
    ))(jstate)
    _assert_traj_close({k: v.numpy() for k, v in traj.items()}, jtraj)


@pytest.mark.parametrize("centralized", [True, False])
def test_sparse_env_obs_controller_and_step_match_jax(centralized):
    x = grid_swarms(3, 256, seed=32)
    (jenv, jp, jstate), (tenv, tp, tstate) = _both_envs(x)
    values, degree = tenv._obs(tstate, tp)
    jvalues, jdegree = jax.vmap(lambda s: jenv._obs(s, jp))(jstate)
    assert _rel(values.numpy(), jvalues) < SUM_TOL
    np.testing.assert_array_equal(degree.numpy(), np.asarray(jdegree))
    u = tenv.controller(tstate, tp, centralized=centralized)
    ju = jax.vmap(lambda s: jenv.controller(s, jp, centralized=centralized))(jstate)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-4)
    st, obs, r, done, _ = tenv.step_env(None, tstate, u, tp)
    jst, jobs, jr, jdone, _ = jax.vmap(
        lambda s, a: jenv.step_env(jax.random.key(0), s, a, jp)
    )(jstate, jnp.asarray(u.numpy()))
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x), rtol=0, atol=1e-5)
    assert _rel(obs[0].numpy(), jobs[0]) < SUM_TOL
    np.testing.assert_array_equal(obs[1].numpy(), np.asarray(jobs[1]))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_sparse_reset_accepts_as_jax_does():
    tenv, tp = gft.make("FlockingSparse-v0", n_agents=256, max_reset_tries=8)
    jenv, jp = gft_jax.make("FlockingSparse-v0", n_agents=256, max_reset_tries=8)
    state, obs = tenv.reset_env(torch.Generator().manual_seed(3), tp, 4)
    x = state.x
    assert x.shape == (4, 256, 4) and 1 <= tenv.last_reset_tries <= 8
    assert float(torch.linalg.norm(x[..., :2], dim=-1).max()) <= math.sqrt(tp.r_max_eff) * (1 + 1e-6)
    accepted = tenv._reset_accept(x, tp).numpy()
    want = np.asarray(jax.vmap(lambda a: jenv._reset_accept(a, jp))(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(accepted, want)
    for got, expect in zip(obs, tenv._obs(state, tp)):
        assert torch.equal(got, expect)


# --------------------------------------------------------- the wrapper


def _bad_inputs():
    xs, _ = _sorted(STATES["normal N=256"]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX)
    return {
        "float64": (xs.double(), table, "core"),
        "int64 table": (xs, table.long(), "core"),
        "ragged N": (xs[:, :200].contiguous(), table, "core"),
        "table rows": (xs, table[:, :1].contiguous(), "core"),
        "non_contiguous": (xs.transpose(0, 1).contiguous().transpose(0, 1), table, "core"),
        "channels": (xs, table, "bogus"),
    }


@pytest.mark.parametrize("name", sorted(_bad_inputs()))
def test_k3_wrapper_rejects_bad_inputs(name):
    """Bad inputs raise, but for two that the wrapper now takes on the CPU:
    float64 runs the plain version and returns float64, and a
    non-contiguous xs gives the contiguous one's result."""
    xs, table, channels = _bad_inputs()[name]
    if name == "float64":
        got = sf.sparse_sums_sorted(xs, table, CR, CR2, channels)
        assert got.dtype == torch.float64
        assert torch.equal(got, sf.sparse_sums_sorted_reference(xs, table, CR, CR2, channels))
    elif name == "non_contiguous":
        got = sf.sparse_sums_sorted(xs, table, CR, CR2, channels)
        assert torch.equal(got, sf.sparse_sums_sorted(xs.contiguous(), table, CR, CR2, channels))
    else:
        with pytest.raises((TypeError, ValueError)):
            sf.sparse_sums_sorted(xs, table, CR, CR2, channels)


@pytest.mark.parametrize("expert", [False, True])
def test_k3_float64_matches_jax_x64(expert):
    """K3's plain version in float64 against ``_sparse_sums_sorted`` under
    x64 on the same sorted f64 operands: the degree exactly, the sums to
    max |port - jax| / (1 + |jax|) < 1e-9 (both f64, other orders)."""
    xs, _ = _sorted(STATES["normal N=256"]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX)
    xs64 = xs.double()
    channels = "expert" if expert else "core"
    got = sf.sparse_sums_sorted(xs64, table, CR, CR2, channels).numpy()
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(lambda a, tb: jsf._sparse_sums_sorted(
            a, tb, CR, CR2, expert=expert))(jnp.asarray(xs64.numpy()), jnp.asarray(table.numpy())))
    assert got.dtype == np.float64 and want.dtype == np.float64
    np.testing.assert_array_equal(got[..., 8], want[..., 8])
    sums = list(range(8)) + ([10, 11] if expert else [])
    assert _rel(got[..., sums], want[..., sums]) < 1e-9


def test_k3_wrapper_raises_on_a_device_other_than_cpu_or_cuda():
    xs = torch.empty(1, 128, 4, device="meta")
    table = torch.empty(1, 1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        sf.sparse_sums_sorted(xs, table, CR, CR2)


def test_k3_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    xs, _ = _sorted(STATES["normal N=256"]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX)
    before = sf.launches
    got = sf.sparse_sums_sorted(xs, table, CR, CR2, "expert")
    assert sf.launches == before
    assert torch.equal(got, sf.sparse_sums_sorted_reference(xs, table, CR, CR2, "expert"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uniform N=1024", "normal N=1024"])
def test_k3_matches_plain_on_the_card(cuda, name):
    xs, _ = _sorted(STATES[name]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX, skin=CR)
    xs, table = xs.to(cuda), table.to(cuda)
    for channels in ("core", "expert", "full"):
        before = sf.launches
        got = sf.sparse_sums_sorted(xs, table, CR, CR2, channels)
        torch.cuda.synchronize()
        assert sf.launches == before + 1
        want = sf.sparse_sums_sorted_reference(xs, table, CR, CR2, channels)
        _assert_sums_close(got.cpu().numpy(), want.cpu().numpy(), channels)


@pytest.mark.cuda
def test_k3_float64_on_the_card_raises(cuda):
    xs, _ = _sorted(STATES["normal N=256"]())
    table, _ = sf.block_pair_table(xs, CR, K_MAX)
    with pytest.raises(TypeError, match="float32"):
        sf.sparse_sums_sorted(xs.double().to(cuda), table.to(cuda), CR, CR2)


@pytest.mark.cuda
@pytest.mark.parametrize("cr", [0.9, 2.0])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_k3_matches_plain_on_edge_cases(cuda, case, cr):
    xs, table = _edge_sorted(case, cr)
    xs, table = xs.to(cuda), table.to(cuda)
    for channels in ("core", "expert", "full"):
        got = sf.sparse_sums_sorted(xs, table, cr, cr * cr, channels).cpu()
        want = sf.sparse_sums_sorted_reference(xs, table, cr, cr * cr, channels).cpu()
        if case == "coincident pair":
            assert torch.equal(got.isnan(), want.isnan())
            assert torch.equal(got[..., 8], want[..., 8])
        else:
            _assert_sums_close(got.numpy(), want.numpy(), channels)
