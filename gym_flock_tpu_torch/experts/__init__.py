"""Host-side experts (counterpart of ``gym_flock_tpu/experts``): the native
VRP solver and the coverage VRP policy on it."""
from gym_flock_tpu_torch.experts.coverage_vrp import CoverageVRPPolicy

__all__ = ["CoverageVRPPolicy"]
