"""ALOHA simulation constants: gripper calibration tables, start pose, DT.

The port's copy of ``latent_diffusion_planning_tpu/envs/aloha_constants.py``
(the reference's ``envs/aloha_constants.py``): DT, the start pose, the
master/puppet gripper position/joint limits with the normalize/unnormalize
helpers built from them, and the per-task episode table. Joint limits and
gains are the MJCF position actuators'
(``bimanual_viperx_transfer_cube.xml:17-24``). Plain Python numbers here;
``envs/aloha_base.py`` moves them to a device once.
"""

from __future__ import annotations

DT = 0.02  # control timestep (s)

JOINT_NAMES = ("waist", "shoulder", "elbow", "forearm_roll", "wrist_angle",
               "wrist_rotate")

# MJCF position-actuator ctrlranges
ARM_JOINT_LO = (-3.14158, -1.85005, -1.76278, -3.14158, -1.8675, -3.14158)
ARM_JOINT_HI = (3.14158, 1.25664, 1.6057, 3.14158, 2.23402, 3.14158)
# actuator kp per joint: the servo tracking bandwidth
ARM_KP = (800.0, 1600.0, 800.0, 10.0, 50.0, 20.0)

# per-arm: 6 joints + 2 finger slide joints; reference start keyframe
START_ARM_QPOS = (0.0, -0.96, 1.16, 0.0, -0.3, 0.0)
START_GRIPPER_POSITION = 0.02239  # left-finger slide qpos at the keyframe

# Left finger position limits (right_finger = -left_finger)
MASTER_GRIPPER_POSITION_OPEN = 0.02417
MASTER_GRIPPER_POSITION_CLOSE = 0.01244
PUPPET_GRIPPER_POSITION_OPEN = 0.05800
PUPPET_GRIPPER_POSITION_CLOSE = 0.01844

# Gripper joint limits (master/puppet gripper revolute joint)
MASTER_GRIPPER_JOINT_OPEN = 0.3083
MASTER_GRIPPER_JOINT_CLOSE = -0.6842
PUPPET_GRIPPER_JOINT_OPEN = 1.4910
PUPPET_GRIPPER_JOINT_CLOSE = -0.6213


def master_gripper_position_normalize(x):
    return ((x - MASTER_GRIPPER_POSITION_CLOSE)
            / (MASTER_GRIPPER_POSITION_OPEN - MASTER_GRIPPER_POSITION_CLOSE))


def puppet_gripper_position_normalize(x):
    return ((x - PUPPET_GRIPPER_POSITION_CLOSE)
            / (PUPPET_GRIPPER_POSITION_OPEN - PUPPET_GRIPPER_POSITION_CLOSE))


def master_gripper_position_unnormalize(x):
    return (x * (MASTER_GRIPPER_POSITION_OPEN - MASTER_GRIPPER_POSITION_CLOSE)
            + MASTER_GRIPPER_POSITION_CLOSE)


def puppet_gripper_position_unnormalize(x):
    return (x * (PUPPET_GRIPPER_POSITION_OPEN - PUPPET_GRIPPER_POSITION_CLOSE)
            + PUPPET_GRIPPER_POSITION_CLOSE)


def master2puppet_position(x):
    return puppet_gripper_position_unnormalize(
        master_gripper_position_normalize(x))


def master_gripper_joint_normalize(x):
    return ((x - MASTER_GRIPPER_JOINT_CLOSE)
            / (MASTER_GRIPPER_JOINT_OPEN - MASTER_GRIPPER_JOINT_CLOSE))


def puppet_gripper_joint_normalize(x):
    return ((x - PUPPET_GRIPPER_JOINT_CLOSE)
            / (PUPPET_GRIPPER_JOINT_OPEN - PUPPET_GRIPPER_JOINT_CLOSE))


def master_gripper_joint_unnormalize(x):
    return (x * (MASTER_GRIPPER_JOINT_OPEN - MASTER_GRIPPER_JOINT_CLOSE)
            + MASTER_GRIPPER_JOINT_CLOSE)


def puppet_gripper_joint_unnormalize(x):
    return (x * (PUPPET_GRIPPER_JOINT_OPEN - PUPPET_GRIPPER_JOINT_CLOSE)
            + PUPPET_GRIPPER_JOINT_CLOSE)


def master2puppet_joint(x):
    return puppet_gripper_joint_unnormalize(master_gripper_joint_normalize(x))


def master_gripper_velocity_normalize(x):
    return x / (MASTER_GRIPPER_POSITION_OPEN - MASTER_GRIPPER_POSITION_CLOSE)


def puppet_gripper_velocity_normalize(x):
    return x / (PUPPET_GRIPPER_POSITION_OPEN - PUPPET_GRIPPER_POSITION_CLOSE)


START_GRIPPER_NORMALIZED = float(
    puppet_gripper_position_normalize(START_GRIPPER_POSITION))

# per-task episode protocol (reference SIM_TASK_CONFIGS)
SIM_TASK_CONFIGS = {
    "sim_transfer_cube_scripted": dict(num_episodes=50, episode_len=400,
                                       camera_names=("wrist64",)),
    "sim_transfer_cube_human": dict(num_episodes=50, episode_len=400,
                                    camera_names=("wrist64",)),
    "sim_insertion_scripted": dict(num_episodes=50, episode_len=400,
                                   camera_names=("wrist64",)),
    "sim_insertion_human": dict(num_episodes=50, episode_len=500,
                                camera_names=("wrist64",)),
}
