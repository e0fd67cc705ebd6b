from gym_flock_tpu_torch.core.env import Env, EnvState, EnvTransition, step_autoreset
from gym_flock_tpu_torch.core import spaces
from gym_flock_tpu_torch.core.registry import make, register, registry
