"""Matplotlib renderers (host code; matplotlib is imported at first draw)."""
from gym_flock_tpu_torch.render.plot import (
    CoverageRenderer,
    FlockingRenderer,
    FormationRenderer,
    FrameWriter,
    ShepherdingRenderer,
    get_renderer,
)
