"""Host utilities: the initial-formation generators, the AirSim settings
parser and the profiling helpers."""
from gym_flock_tpu_torch.utils.formations import circle, grid, parse_settings, twoflocks
from gym_flock_tpu_torch.utils.profiling import measure_steps_per_second, trace

__all__ = ["circle", "grid", "twoflocks", "parse_settings", "trace", "measure_steps_per_second"]
