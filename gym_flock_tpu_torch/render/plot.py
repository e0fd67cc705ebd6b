"""Matplotlib renderers, host code (counterpart of
``gym_flock_tpu/render/plot.py``): each creates its artists once and
updates their data between frames, in the reference's visual conventions:

* flocking:    blue agent dots, origin cross (flocking_relative.py:234-257)
* coverage:    blue motion edges, green robots, red unvisited / blue visited
               targets, reward text (coverage.py:434-508)
* shepherding: green shepherd / red sheep quivers, goal circle
               (shepherding.py:275-325)
* formation:   start crosses, goal crosses, agent dots (formation_flying.py:180-210)

``draw(state)`` takes ONE env's state with NumPy fields (the facades pass
``first(fetch(state))``); bank tensors are read off their device once a
graph.  ``matplotlib`` is imported when a renderer first draws, never when
this module is imported.
"""
from __future__ import annotations

import numpy as np

__all__ = ["get_renderer", "FrameWriter", "FlockingRenderer", "CoverageRenderer",
           "ShepherdingRenderer", "FormationRenderer"]


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    """A tensor on any device, or an array, as a NumPy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return (x.float() if str(x.dtype) == "torch.bfloat16" else x).numpy()
    return np.asarray(x)


class _Base:
    def __init__(self):
        self.fig = None

    def close(self):
        if self.fig is not None:
            _plt().close(self.fig)
            self.fig = None

    def _flush(self):
        self.fig.canvas.draw()
        self.fig.canvas.flush_events()


class FlockingRenderer(_Base):
    def __init__(self, env, params):
        super().__init__()
        self.params = params

    def draw(self, state):
        plt = _plt()
        x = _np(state.x)
        r_max = self.params.r_max_eff
        if self.fig is None:
            plt.ion()
            self.fig = plt.figure()
            self.ax = self.fig.add_subplot(111)
            (self.line1,) = self.ax.plot(x[:, 0], x[:, 1], "bo")
            self.ax.plot([0], [0], "kx")
            self.ax.set_ylim(-1.0 * r_max, 1.0 * r_max)
            self.ax.set_xlim(-1.0 * r_max, 1.0 * r_max)
            self.ax.set_title("GNN Controller")
        self.line1.set_xdata(x[:, 0])
        self.line1.set_ydata(x[:, 1])
        self._flush()


class CoverageRenderer(_Base):
    """Coverage-family renderer (reference coverage.py:434-508): motion
    edges in blue, robots green, unvisited targets red, visited blue,
    frontier nodes as white dots (hide_nodes mode), and, when ``horizon``
    is set, robot 0's graph-cost neighborhood as yellow dots (reference
    line4, coverage.py:498-503)."""

    def __init__(self, env, params, horizon: int = -1):
        super().__init__()
        self.params = params
        self.horizon = horizon
        self._graph = None

    def draw(self, state):
        plt = _plt()
        p = self.params
        g = int(state.graph)
        if self.fig is None or self._graph != g:
            self.close()
            self._graph = g
            bank = p.bank
            self._pos = _np(bank["target_pos"][g])
            self._mask = _np(bank["target_mask"][g])
            self._senders = _np(bank["motion_senders"][g])
            self._receivers = _np(bank["motion_receivers"][g])
            self._cost = _np(bank["graph_cost"][g]) if self.horizon > -1 else None
            pos, mask = self._pos, self._mask
            plt.ion()
            self.fig = plt.figure()
            self.ax = self.fig.add_subplot(111)
            self._text = self.ax.text(
                pos[mask][:, 0].max(), pos[mask][:, 1].max(), "", fontsize=32
            )
            valid = self._senders >= 0
            for s, r in zip(self._senders[valid], self._receivers[valid]):
                s -= p.n_robots
                r -= p.n_robots
                self.ax.plot([pos[s, 0], pos[r, 0]], [pos[s, 1], pos[r, 1]], "b", lw=0.5)
            (self.l_unvis,) = self.ax.plot([], [], "ro", markersize=10)
            (self.l_vis,) = self.ax.plot([], [], "bo", markersize=5)
            (self.l_horizon,) = self.ax.plot([], [], "y.")
            (self.l_front,) = self.ax.plot([], [], "w.")
            (self.l_robot,) = self.ax.plot([], [], "go", markersize=15, linewidth=0)
        pos, mask = self._pos, self._mask

        visited = _np(state.visited) > 0
        discovered = _np(state.discovered) > 0
        robot_loc = _np(state.robot_loc)
        robot_pos = pos[robot_loc]

        show = mask if not p.hide_nodes else (mask & discovered)
        unvis = show & ~visited
        vis = show & visited
        self.l_unvis.set_data(pos[unvis, 0], pos[unvis, 1])
        self.l_vis.set_data(pos[vis, 0], pos[vis, 1])
        self.l_robot.set_data(robot_pos[:, 0], robot_pos[:, 1])

        if p.hide_nodes:
            # frontier overlay (reference line5, coverage.py:487-489):
            # discovered receivers of motion edges whose sender is still
            # undiscovered
            valid = self._senders >= 0
            s_t = self._senders[valid] - p.n_robots
            r_t = self._receivers[valid] - p.n_robots
            frontier = np.zeros(pos.shape[0], dtype=bool)
            edge_front = (~discovered[s_t]) & discovered[r_t]
            np.logical_or.at(frontier, r_t, edge_front)
            frontier &= mask
            self.l_front.set_data(pos[frontier, 0], pos[frontier, 1])

        if self.horizon > -1:
            # robot 0's graph-cost neighborhood (reference coverage.py:498-503)
            nb = (self._cost[robot_loc[0]] <= self.horizon) & mask
            self.l_horizon.set_data(pos[nb, 0], pos[nb, 1])
        self._text.set_text(str(int(_np(state.episode_reward))))
        self._flush()


class ShepherdingRenderer(_Base):
    def __init__(self, env, params):
        super().__init__()
        self.params = params

    def draw(self, state):
        plt = _plt()
        p = self.params
        x = _np(state.x)
        S = p.n_shepherds
        uv = [np.cos(x[:, 2]), np.sin(x[:, 2])]
        if self.fig is None:
            import matplotlib.patches as patches

            plt.ion()
            self.fig = plt.figure()
            self.ax = self.fig.add_subplot(111, aspect="equal")
            self.q1 = self.ax.quiver(
                x[:S, 0], x[:S, 1], uv[0][:S], uv[1][:S],
                units="xy", scale=2, width=0.1, color="g", headlength=4.5, headwidth=3,
            )
            self.q2 = self.ax.quiver(
                x[S:, 0], x[S:, 1], uv[0][S:], uv[1][S:],
                units="xy", scale=2, width=0.1, color="r", headlength=4.5, headwidth=3,
            )
            self.ax.add_patch(
                patches.Circle((0, 0), p.goal_region_radius, fill=False, edgecolor="r"))
            self.ax.plot([0], [0], "kx")
            gx, gy = p.goal_offset
            self.ax.set_xlim(-3.0 * p.r_max + gx, p.r_max)
            self.ax.set_ylim(-3.0 * p.r_max + gy, p.r_max)
        self.q1.set_offsets(x[:S, 0:2])
        self.q1.set_UVC(uv[0][:S], uv[1][:S])
        self.q2.set_offsets(x[S:, 0:2])
        self.q2.set_UVC(uv[0][S:], uv[1][S:])
        self._flush()


class FormationRenderer(_Base):
    def __init__(self, env, params):
        super().__init__()
        self.params = params

    def draw(self, state):
        plt = _plt()
        x = _np(state.x)
        if self.fig is None:
            plt.ion()
            self.fig = plt.figure()
            self.ax = self.fig.add_subplot(111)
            (self.line1,) = self.ax.plot(x[:, 0], x[:, 1], "bo")
            self.ax.plot(x[:, 0], x[:, 1], "kx")
            self.ax.plot(x[:, 2], x[:, 3], "rx")
            r = self.params.r_max
            self.ax.set_xlim(-r, r)
            self.ax.set_ylim(-r, r)
            self.ax.set_title("GNN Controller")
        self.line1.set_xdata(x[:, 0])
        self.line1.set_ydata(x[:, 1])
        self._flush()


def get_renderer(env_id: str, env, params, horizon: int = -1):
    """The family's renderer for ``env`` (dispatch by class; ``env_id`` is
    kept for the JAX package's signature).  ``horizon >= 0`` turns on the
    coverage renderer's graph-cost neighborhood overlay."""
    from gym_flock_tpu_torch.envs.coverage import CoverageEnv
    from gym_flock_tpu_torch.envs.flocking import FlockingRelativeEnv
    from gym_flock_tpu_torch.envs.formation import FormationFlyingEnv
    from gym_flock_tpu_torch.envs.shepherding import ShepherdingEnv

    if isinstance(env, CoverageEnv):
        return CoverageRenderer(env, params, horizon=horizon)
    if isinstance(env, ShepherdingEnv):
        return ShepherdingRenderer(env, params)
    if isinstance(env, FormationFlyingEnv):
        return FormationRenderer(env, params)
    if isinstance(env, FlockingRelativeEnv):
        return FlockingRenderer(env, params)
    raise ValueError(f"No renderer for {env!r}")


class FrameWriter:
    """Headless frame capture around any renderer:
    ``FrameWriter(renderer, out_dir)``, ``capture(state)`` a step, then e.g.
    ``ffmpeg -i frame_%04d.png out.mp4``."""

    def __init__(self, renderer, out_dir: str, dpi: int = 80):
        import os

        self.renderer = renderer
        self.out_dir = out_dir
        self.dpi = dpi
        self.count = 0
        os.makedirs(out_dir, exist_ok=True)

    def capture(self, state) -> str:
        import os

        self.renderer.draw(state)
        path = os.path.join(self.out_dir, f"frame_{self.count:04d}.png")
        self.renderer.fig.savefig(path, dpi=self.dpi)
        self.count += 1
        return path
