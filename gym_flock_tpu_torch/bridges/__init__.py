"""AirSim and ROS bridges: host code with the simulator client injected."""
from gym_flock_tpu_torch.bridges.airsim_bridge import (
    AirsimCoverageBridge,
    AirsimFlockingBridge,
    quaternion_to_yaw,
)
from gym_flock_tpu_torch.bridges.ros_bridge import RosCoverageDriver
