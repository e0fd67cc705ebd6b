"""The port's coverage GNN update against the benchmark's plain reference
(``portbench/reference/edge_graph_net.py``), on the CPU at a small size:
the procedural ExploreFullEnv-v0 world (``GYM_FLOCK_TPU_MAPS=off``), one
collect of B=2 worlds x 3 steps shared by every test, ``EdgeGraphNet(64,
6)`` on weights drawn from two seeds.

Tolerances: the edge and action logits, the node states and the loss
within 1e-5 of 1 + |ref|, the gradients within 1e-5 of the largest
gradient.  Both sides compute in float32 from the same weights; they sum in
other orders (the port's dense layers over the whole padded batch, the
reference's one graph at a time), so they differ by float32 rounding
carried through six rounds of 64-wide sums, ~1e-7 to 1e-6; one dense
layer in bfloat16 moves them by ~1e-2.  Adam's new weights within 5e-7,
about two float32 spacings at the largest weight (|w| < 2.3).

The bfloat16 control, the planted faults and a gradient wrong in one layer
alone read above the cell's limits
(``portbench/limits/explore_full_arl_bc.bc_train.json``), and the port's
spans and its ``message_rows`` counter are held to what the benchmark's
readers expect.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import gym_flock_tpu_torch as gft
from gym_flock_tpu_torch.models.gnn import EdgeGraphNet
from gym_flock_tpu_torch.parallel.train_coverage import (
    CoverageImitationTrainer,
    _graph,
    action_edge_logits,
    collect_coverage_batch,
)
from gym_flock_tpu_torch.utils import profiling
from portbench import bc_checks, harness
from portbench.reference import edge_graph_net as ref

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
B, STEPS = 2, 3
SEEDS = (0, 7)
TOL = 1e-5
ADAM_TOL = 5e-7
OPT = {"lr": 1e-3, "betas": (0.9, 0.999), "eps": 1e-8}
LIMITS = json.loads((REPO / "portbench" / "limits"
                     / "explore_full_arl_bc.bc_train.json").read_text())
UPDATE_GAPS = ("loss_gap", "grad_gap", "adam_gap")
TRAIN_SPANS = ("gft.train.collect", "gft.train.update", "gft.train.forward",
               "gft.train.backward", "gft.train.adam")


@pytest.fixture(scope="module")
def world():
    env, params = gft.make("ExploreFullEnv-v0", device="cpu")
    assert params.n_robots == 100 and params.n_node_feat == 4 and params.n_comm_edges == 0
    batch = collect_coverage_batch(env, params, torch.Generator().manual_seed(1), B, STEPS)
    assert bool((batch["senders"] == -1).any())  # hidden nodes leave padded edges
    return env, params, batch


def model(params, seed):
    return EdgeGraphNet(64, 6, n_node_feat=params.n_node_feat, n_edge_feat=params.n_edge_feat,
                        generator=torch.Generator().manual_seed(seed))


def trainer(world, seed):
    env, params, _ = world
    return CoverageImitationTrainer(env, params, model=model(params, seed),
                                    learning_rate=OPT["lr"], device="cpu")


def weights(m):
    return {k: v.detach() for k, v in m.named_parameters()}


def rel(p, r):
    return float(((p - r).abs() / (1.0 + r.abs())).max())


def kept_update(t, batch):
    """One update of trainer ``t`` with what the benchmark's check keeps."""
    named = dict(t.model.named_parameters())
    entry = {"batch": batch, **bc_checks.before(named, t.optimizer.state)}
    entry.update(bc_checks.after(named, t.update(batch)))
    return entry


def gaps(world, entries):
    _, params, _ = world
    return bc_checks.update_gaps(entries, params.n_robots, params.n_actions, OPT["lr"],
                                 OPT["betas"], OPT["eps"])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_logits_equal_the_reference(world, seed):
    _, params, batch = world
    m = model(params, seed)
    with torch.no_grad():
        h, edge_logits = m(_graph(batch))
        actions = action_edge_logits(edge_logits, params)
        w = weights(m)
        for i in range(B * STEPS):
            h_r, z_r = ref.forward(w, ref.sample(batch, i))
            assert rel(h[i], h_r) <= TOL, i
            assert rel(edge_logits[i, :, 0], z_r) <= TOL, i
            want = ref.action_logits(z_r, params.n_robots, params.n_actions)
            assert rel(actions[i], want) <= TOL, i


@pytest.mark.parametrize("seed", SEEDS)
def test_the_loss_gradients_and_adam_steps_equal_the_reference(world, seed):
    _, params, batch = world
    t = trainer(world, seed)
    for update in range(2):  # from fresh moments, then from the first step's
        e = kept_update(t, batch)
        loss, grads = ref.loss_and_grads(e["weights"], batch, params.n_robots, params.n_actions,
                                         block=4)
        assert abs(float(e["loss"]) - float(loss)) <= TOL * (1.0 + abs(float(loss))), update
        scale = max(float(g.abs().max()) for g in grads.values())
        assert scale > 0
        for k, g in grads.items():
            assert float((e["grads"][k] - g).abs().max()) <= TOL * scale, (update, k)
        steps = {k: float(s) for k, s in e["step"].items()}
        # Adam skips the last node MLP, which feeds no logit (no gradient)
        assert {s for k, s in steps.items() if not k.startswith("node_mlps.5.")} == {update}
        want, _, _ = ref.adam(e["weights"], e["grads"], e["exp_avg"], e["exp_avg_sq"], steps,
                              OPT["lr"], OPT["betas"], OPT["eps"])
        for k, w in want.items():
            assert float((e["after"][k].double() - w).abs().max()) <= ADAM_TOL, (update, k)
        assert float(grads["node_mlps.5.layers.0.weight"].abs().max()) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_padded_edges_add_nothing(world, seed):
    _, params, batch = world
    pad = batch["senders"] == -1
    g = torch.Generator().manual_seed(seed + 100)
    noisy = dict(batch)
    noisy["edges"] = torch.where(pad[..., None], 50.0 * torch.rand(batch["edges"].shape,
                                                                   generator=g),
                                 batch["edges"])
    noisy["receivers"] = torch.where(pad, torch.randint(0, params.max_nodes, pad.shape,
                                                        generator=g, dtype=torch.int32),
                                     batch["receivers"])
    m = model(params, seed)
    w = weights(m)
    with torch.no_grad():
        h, z = m(_graph(batch))
        h2, z2 = m(_graph(noisy))
        assert torch.equal(h, h2)
        assert torch.equal(z[~pad], z2[~pad])
        for i in range(B * STEPS):
            h_r, z_r = ref.forward(w, ref.sample(batch, i))
            h_n, z_n = ref.forward(w, ref.sample(noisy, i))
            assert torch.equal(h_r, h_n) and torch.equal(z_r[~pad[i]], z_n[~pad[i]])
            # the graph without its padded edges: the same nodes and actions
            real = ~pad[i]
            h_d, z_d = ref.forward(w, {k: v[real] if k != "nodes" else v
                                       for k, v in ref.sample(batch, i).items()})
            assert rel(h_d, h_r) <= TOL
            assert rel(ref.action_logits(z_d, params.n_robots, params.n_actions),
                       ref.action_logits(z_r, params.n_robots, params.n_actions)) <= TOL


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("system", ["program", "control", "round_dropped", "half_batch",
                                    "update_skipped", "grad_dropped"])
def test_only_the_sound_update_reads_within_the_cells_limits(world, system, seed):
    """The port reads within every limit of the update; the bfloat16 control
    and each planted fault read above at least one."""
    _, params, batch = world
    drv = harness.driver("bc_train")
    t = trainer(world, seed)
    if system == "control":
        t = drv.ControlTrainer(t, params.n_robots, params.n_actions,
                               {**OPT, "betas": list(OPT["betas"])})
        named, state = t.params, t.state
    else:
        if system != "program":
            drv.plant(t, system)
        named, state = dict(t.model.named_parameters()), t.optimizer.state
    entry = {"batch": batch, **bc_checks.before(named, state)}
    entry.update(bc_checks.after(named, t.update(batch)))
    got = gaps(world, [entry])
    above = [k for k in UPDATE_GAPS if not got[k] <= LIMITS[k]]
    if system == "program":
        assert above == [], got
    else:
        assert above, got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name,scale", [("logit_head.layers.1.weight", 0.0),
                                        ("edge_encoder.layers.0.weight", 0.0),
                                        ("message_mlps.0.layers.0.weight", 0.5),
                                        ("node_mlps.2.layers.1.weight", 1.5)])
def test_a_wrong_gradient_in_one_layer_reads_above_the_gradient_limit(world, name, scale,
                                                                      seed):
    """One parameter's gradient dropped or mis-scaled before Adam, every other
    right: only ``grad_gap`` sees it, and it reads above its limit however
    small a share of the model's weights the parameter holds."""
    _, _, batch = world
    t = trainer(world, seed)
    named = dict(t.model.named_parameters())
    inner = t.adam_step

    def adam_step():
        named[name].grad.mul_(scale)
        inner()

    t.adam_step = adam_step
    got = gaps(world, [kept_update(t, batch)])
    assert named[name].numel() < 0.1 * sum(p.numel() for p in named.values())
    assert got["grad_gap"] > LIMITS["grad_gap"], got
    assert got["loss_gap"] <= LIMITS["loss_gap"] and got["adam_gap"] <= LIMITS["adam_gap"], got


@pytest.mark.parametrize("seed", SEEDS)
def test_a_train_step_records_every_train_span_and_a_round_span_a_round(world, seed,
                                                                       tmp_path):
    env, params, _ = world
    t = trainer(world, seed)
    gen = torch.Generator().manual_seed(seed)
    t.train_step(gen, B, 1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t.train_step(gen, B, 1)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [str(e.get("name")) for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    assert {s: names.count(s) for s in TRAIN_SPANS} == {s: 1 for s in TRAIN_SPANS}
    assert names.count("gft.gnn.round") == 6


@pytest.mark.parametrize("seed", SEEDS)
def test_without_a_profiler_an_update_counts_its_message_rows_and_reads_no_host(
        world, seed, monkeypatch):
    _, params, batch = world
    t = trainer(world, seed)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    syncs, rows = profiling.syncs, t.model.message_rows
    t.update(batch)
    assert profiling.syncs == syncs
    assert t.model.message_rows - rows == B * STEPS * params.max_edges * 6


def test_the_reference_loads_neither_package_nor_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import portbench.reference.edge_graph_net; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'gym_flock_tpu_torch', 'gym_flock_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip() == "[]"
