"""The gym-facing entry points: the reference's gym 0.11 surface
(:func:`make_legacy`) and Gymnasium's single and vector surfaces
(:func:`make_gymnasium`, :func:`make_gymnasium_vector`), each on
``device="cuda"`` unless the caller asks for the host."""
from gym_flock_tpu_torch.compat.gym_api import (
    FlattenDictWrapper,
    LegacyEnv,
    load_cfg_section,
    make_legacy,
)
from gym_flock_tpu_torch.compat.gymnasium_api import GymnasiumEnv, make_gymnasium
from gym_flock_tpu_torch.compat.gymnasium_vector import (
    GymnasiumVectorEnv,
    batch_space,
    make_gymnasium_vector,
)

__all__ = ["FlattenDictWrapper", "LegacyEnv", "load_cfg_section", "make_legacy",
           "GymnasiumEnv", "make_gymnasium", "GymnasiumVectorEnv", "batch_space",
           "make_gymnasium_vector"]
