"""Visual self-test of the PyTorch port's map generation (counterpart of
``examples/plot_maps.py``).

The reference's inline demo (make_map.py:183-204: a sheared lattice with
rectangular obstacles rejected), extended to every map source the coverage
envs use: the triangular lattice with obstacle rejection, the road-lattice
world (Delaunay waypoints) and, when ``grid_slice10.npy`` is found (the
bundled map by default), the real ARL facility's free cells next to a wall.
The maps are host arrays: nothing here runs on the GPU.  matplotlib is
imported when the script runs, not when it is imported.

Headless by default: writes PNGs to --out (default ./map_plots).  --show
opens windows instead (needs a display).

Usage:  python examples/torch_plot_maps.py [--out DIR] [--show]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="map_plots")
    ap.add_argument("--show", action="store_true")
    args = ap.parse_args(argv)

    import matplotlib

    if not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from gym_flock_tpu_torch.envs.coverage_graph import (
        generate_coverage_targets,
        generate_lattice,
        reject_collisions,
        targets_from_occupancy,
    )
    from gym_flock_tpu_torch.envs.maps import find_reference_map

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    made = []

    def finish(name):
        if args.show:
            plt.show()
        else:
            path = out / f"{name}.png"
            plt.savefig(path, dpi=120, bbox_inches="tight")
            plt.close()
            made.append(path)

    # 1. the reference demo's sheared lattice and obstacles (make_map.py:186-201)
    lattice_vectors = [3.0 * np.array([-1.44, -1.44]), 3.0 * np.array([-1.44, 1.44])]
    spots = generate_lattice((0, 100, 0, 100), lattice_vectors)
    spots = reject_collisions(spots, [(10, 45, 10, 90), (55, 90, 10, 90)])
    plt.figure(figsize=(5, 5))
    plt.plot(spots[:, 1], spots[:, 0], ".")
    plt.title("sheared lattice + obstacle rejection")
    finish("lattice_obstacles")

    # 2. the road-lattice world of Coverage-v0 (reference coverage.py:516-527)
    targets = generate_coverage_targets(np.random.RandomState(3))
    plt.figure(figsize=(5, 5))
    plt.plot(targets[:, 0], targets[:, 1], ".", markersize=3)
    plt.title(f"road-lattice targets (n={len(targets)})")
    finish("road_lattice")

    # 3. the real ARL facility map, when it is found (bundled by default)
    path = find_reference_map(10)
    if path is not None:
        t = targets_from_occupancy(path=path, downsample_rate=10, perimeter_delta=2.0)
        plt.figure(figsize=(6, 6))
        plt.plot(t[:, 0], t[:, 1], ".", markersize=2)
        plt.title(f"ARL facility free cells (n={len(t)})")
        finish("arl_facility")
    else:
        print("no grid_slice10.npy found; the ARL plot is left out")

    for p in made:
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
