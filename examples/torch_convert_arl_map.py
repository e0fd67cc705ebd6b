"""Convert the reference's real ARL occupancy map into the PyTorch port's
cached graph banks (counterpart of ``examples/convert_arl_map.py``).

Finds ``grid_slice10.npy`` (the map every reference occupancy env uses:
coverage_arl.py:19, coverage_full.py:3, coverage_explore_full.py:3), builds
each occupancy variant's graph bank from it, and leaves the bank in the
port's disk cache (``$GYM_FLOCK_TPU_TORCH_CACHE``, default
``~/.cache/gym_flock_tpu_torch``), so that every later
``gym_flock_tpu_torch.make("CoverageARL-v0")`` and the like, in any process,
reads the real world instead of rebuilding its all-pairs hop costs (tens
of seconds for the full-facility variants).  The bank is placed on the GPU
unless ``--cpu`` is given.

Usage::

    python examples/torch_convert_arl_map.py                 # all variants
    python examples/torch_convert_arl_map.py --variants CoverageFull-v0
    python examples/torch_convert_arl_map.py --maps-dir /path/with/grid_slice10.npy
    python examples/torch_convert_arl_map.py --out banks/    # also export .npz

The map search order is ``gym_flock_tpu_torch/envs/maps.py``'s
($GYM_FLOCK_TPU_MAPS, the bundled map, an installed gym_flock,
$GYM_FLOCK_REFERENCE).
"""
import argparse
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

ALL_VARIANTS = ["CoverageARL-v0", "CoverageFull-v0", "ExploreEnv-v0", "ExploreFullEnv-v0"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=ALL_VARIANTS,
                    help=f"env ids to convert (default: {' '.join(ALL_VARIANTS)})")
    ap.add_argument("--maps-dir", default=None,
                    help="directory containing grid_slice10.npy (overrides the search)")
    ap.add_argument("--map", dest="map_path", default=None,
                    help="explicit path to an occupancy .npy")
    ap.add_argument("--out", default=None,
                    help="also export each bank as <out>/<env-id>.npz "
                         "(loadable with coverage_graph.load_graph_bank)")
    ap.add_argument("--cpu", action="store_true", help="place the banks on the host")
    args = ap.parse_args(argv)

    if args.maps_dir:
        os.environ["GYM_FLOCK_TPU_MAPS"] = args.maps_dir

    from gym_flock_tpu_torch.compat.gym_api import make_on
    from gym_flock_tpu_torch.envs.coverage import bank_cache_dir, last_bank_timing
    from gym_flock_tpu_torch.envs.coverage_graph import save_graph_bank
    from gym_flock_tpu_torch.envs.maps import find_reference_map

    map_path = args.map_path or find_reference_map(10)
    if map_path is None:
        print("No grid_slice10.npy found. Set $GYM_FLOCK_TPU_MAPS or "
              "$GYM_FLOCK_REFERENCE, or pass --maps-dir / --map.", file=sys.stderr)
        return 1
    print(f"map: {map_path}")
    print(f"bank cache: {bank_cache_dir()}")

    for env_id in args.variants:
        t0 = time.time()
        _, params = make_on(env_id, "cpu" if args.cpu else "cuda", real_map=map_path)
        n_t = params.bank["n_targets"].cpu()
        print(f"{env_id}: {len(n_t)} graph(s), targets/graph {int(n_t.min())}.."
              f"{int(n_t.max())}, node budget {params.max_nodes} ({params.n_robots} robots), "
              f"{last_bank_timing.get('source', 'memo')} in {time.time() - t0:.1f}s")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            out = os.path.join(args.out, f"{env_id}.npz")
            save_graph_bank(out, params.bank)
            print(f"  exported {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
