#!/usr/bin/env python3
"""``make_legacy``'s controller/step loop on one NVIDIA GPU: this checkout
against another one (a parent commit), in turns.

Run from the repository root with one visible card:

    git archive <commit> | tar -x -C build/parent
    python3 tools/compare_legacy_parent.py --parent build/parent [--out FILE]

Each turn is a fresh process that imports one checkout's
``gym_flock_tpu_torch`` and runs, on FlockingRelative-v0, Coverage-v0 and
CoverageARL-v0 (real map), 1500 pairs of ``u = env.controller()`` (the
greedy expert on the coverage ids, wrapped in ``FlattenDictWrapper``)
followed by a step, resetting where an episode ends.  The step takes ``u``
with probability ``beta`` and a learner's action otherwise (``u`` plus
N(0, 0.1) noise on flocking, a uniform action index on coverage), as a
DAgger driver mixes them: ``expert`` is beta 1, ``mixed`` 0.5 and
``learner`` 0 (the controller asked for labels only).  One warm-up loop of
each id comes first.  The turns are ``PAIRS_OF_TURNS`` pairs, each of a
parent turn and a turn of this checkout, alternating which goes first.
Prints the card's name and power limit, each turn's pairs/s and, where the
checkout counts them, the pairs its queues computed and its controller
evaluations, then for each id and beta the medians and quartiles of both
sides and the pairs of turns this checkout won (one JSON object, last);
everything goes to ``--out`` too (default
``build/probe/compare_legacy_parent.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
IDS = (("FlockingRelative-v0", {}), ("Coverage-v0", {}), ("CoverageARL-v0", {"real_map": True}))
MODES = (("expert", 1.0), ("mixed", 0.5), ("learner", 0.0))
PAIRS = 1500
WARMUP_PAIRS = 200
PAIRS_OF_TURNS = 10
SEED = 0


def loop(env_id: str, kw: dict, beta: float, pairs: int) -> dict:
    """``pairs`` controller/step pairs on a fresh facade; pairs/s and the
    facade's counts."""
    import numpy as np
    import torch

    from gym_flock_tpu_torch.compat import FlattenDictWrapper, make_legacy

    legacy = make_legacy(env_id, device="cuda", **kw)
    coverage = env_id.startswith("Coverage")
    env = FlattenDictWrapper(legacy) if coverage else legacy
    rng = np.random.RandomState(SEED)
    legacy.seed(SEED)
    env.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(pairs):
        u = legacy.controller(greedy=True) if coverage else legacy.controller()
        if rng.uniform() >= beta:
            if coverage:
                u = rng.randint(0, legacy.params.n_actions, np.shape(u))
            else:
                u = u + rng.normal(0.0, 0.1, u.shape).astype(u.dtype)
        if env.step(u)[2]:
            env.reset()
    torch.cuda.synchronize()
    return {"pairs_per_s": pairs / (time.perf_counter() - t0),
            "computed_pairs": getattr(legacy, "computed_pairs", None),
            "controller_evals": getattr(legacy, "controller_evals", None)}


def turn(root: str, cache: str) -> None:
    """One checkout's loops, in this process; prints one JSON line."""
    import os

    sys.path.insert(0, root)
    from gym_flock_tpu_torch.envs.coverage import CACHE_ENV
    from gym_flock_tpu_torch.ops import _build

    os.environ[CACHE_ENV] = cache
    _build.load()
    out = {}
    for env_id, kw in IDS:
        loop(env_id, kw, 1.0, WARMUP_PAIRS)
        out[env_id] = {mode: loop(env_id, kw, beta, PAIRS) for mode, beta in MODES}
    print(json.dumps(out))


def summary(turns: list) -> dict:
    """For each id and beta: both sides' pairs/s quartiles (25%, 50%,
    75%) and the pairs of turns in which this checkout was faster."""
    import numpy as np

    out = {}
    for env_id, _ in IDS:
        for mode, _ in MODES:
            rate = {side: [t["loops"][env_id][mode]["pairs_per_s"] for t in turns
                           if t["checkout"] == side] for side in ("parent", "this")}
            out[f"{env_id} {mode}"] = {
                **{side: np.percentile(r, [25, 50, 75]).tolist() for side, r in rate.items()},
                "this_won": sum(t > p for p, t in zip(rate["parent"], rate["this"])),
                "pairs_of_turns": len(rate["this"])}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="an unpacked checkout to compare with")
    ap.add_argument("--out", default=str(ROOT / "build" / "probe" / "compare_legacy_parent.json"))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    ap.add_argument("--cache", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        turn(args.turn, args.cache)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    parent = str(Path(args.parent).resolve())
    result = {"card": smi, "pairs": PAIRS, "modes": dict(MODES), "turns": []}
    sides = (("parent", parent), ("this", str(ROOT)))
    order = [side for i in range(PAIRS_OF_TURNS)
             for side in (sides if i % 2 == 0 else sides[::-1])]
    with tempfile.TemporaryDirectory(prefix="legacy_cmp_cache_") as cache:
        for name, root in order:
            proc = subprocess.run([sys.executable, __file__, "--parent", parent, "--turn", root,
                                   "--cache", cache], capture_output=True, text=True,
                                  timeout=900, cwd=root)
            if proc.returncode != 0:
                raise RuntimeError(f"the {name} turn failed:\n{proc.stderr[-3000:]}")
            rates = json.loads(proc.stdout.strip().splitlines()[-1])
            print(name, json.dumps(rates), flush=True)
            result["turns"].append({"checkout": name, "loops": rates})
    result["summary"] = summary(result["turns"])
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
