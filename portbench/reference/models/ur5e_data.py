"""Baked kinematic/inertial tables, copied verbatim from
roboticsplayroompybullet_tpu/models/ur5e_data.py (generated there by
tools/extract_urdf.py from the reference URDF
roboticsPlayroomPybullet/envs/ur_e_description/ur5e2.urdf; joint indexing mirrors
PyBullet's depth-first file-order convention, so joint i here ==
bullet joint i). DO NOT EDIT BY HAND."""

ROOT_LINK = 'base_link'
LINK_NAMES = ['base_link', 'shoulder_link', 'upper_arm_link', 'forearm_link', 'wrist_1_link', 'wrist_2_link', 'wrist_3_link', 'ee_link', 'grasptarget', 'tool0', 'robotiq_arg2f_base_link', 'robotiq_2f_85_left_driver', 'robotiq_2f_85_left_coupler', 'robotiq_2f_85_left_spring_link', 'robotiq_2f_85_right_driver', 'robotiq_2f_85_right_coupler', 'robotiq_2f_85_right_spring_link', 'robotiq_ur_coupler', 'robotiq_2f_85_base', 'robotiq_2f_85_left_pad', 'robotiq_2f_85_left_follower', 'robotiq_2f_85_right_pad', 'robotiq_2f_85_right_follower']

# One row per joint/child-link (bullet joint index order).
# type: 0=revolute 1=prismatic 2=fixed
JOINTS = [
    # [0] shoulder_pan_joint  (revolute)  base_link -> shoulder_link
    dict(
        name='shoulder_pan_joint', type=0,
        parent=0, child=1,
        xyz=[0.0, 0.0, 0.083], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-6.28318530718, upper=6.28318530718, effort=150.0,
        velocity=3.14, damping=0.0,
        mass=3.7, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.010267495893, 0.010267495893, 0.00666, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [1] shoulder_lift_joint  (revolute)  shoulder_link -> upper_arm_link
    dict(
        name='shoulder_lift_joint', type=0,
        parent=1, child=2,
        xyz=[0.0, 0.13, 0.0], rpy=[0.0, 1.57079632679, 0.0], axis=[0.0, 1.0, 0.0],
        lower=-6.28318530718, upper=6.28318530718, effort=150.0,
        velocity=3.14, damping=0.0,
        mass=8.393, com=[0.0, 0.0, 0.2125], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.133885781862, 0.133885781862, 0.0151074, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [2] elbow_joint  (revolute)  upper_arm_link -> forearm_link
    dict(
        name='elbow_joint', type=0,
        parent=2, child=3,
        xyz=[0.0, -0.111, 0.425], rpy=[0.0, 0.0, 0.0], axis=[0.0, 1.0, 0.0],
        lower=-3.14159265359, upper=3.14159265359, effort=150.0,
        velocity=3.14, damping=0.0,
        mass=2.275, com=[0.0, 0.0, 0.196], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0311796208615, 0.0311796208615, 0.004095, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [3] wrist_1_joint  (revolute)  forearm_link -> wrist_1_link
    dict(
        name='wrist_1_joint', type=0,
        parent=3, child=4,
        xyz=[0.0, 0.0, 0.392], rpy=[0.0, 1.57079632679, 0.0], axis=[0.0, 1.0, 0.0],
        lower=-6.28318530718, upper=6.28318530718, effort=28.0,
        velocity=6.28, damping=0.0,
        mass=1.219, com=[0.0, 0.127, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.00255989897604, 0.00255989897604, 0.0021942, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [4] wrist_2_joint  (revolute)  wrist_1_link -> wrist_2_link
    dict(
        name='wrist_2_joint', type=0,
        parent=4, child=5,
        xyz=[0.0, 0.095, 0.0], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-6.28318530718, upper=6.28318530718, effort=28.0,
        velocity=6.28, damping=0.0,
        mass=1.219, com=[0.0, 0.0, 0.1], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.00255989897604, 0.00255989897604, 0.0021942, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [5] wrist_3_joint  (revolute)  wrist_2_link -> wrist_3_link
    dict(
        name='wrist_3_joint', type=0,
        parent=5, child=6,
        xyz=[0.0, 0.0, 0.1], rpy=[0.0, 0.0, 0.0], axis=[0.0, 1.0, 0.0],
        lower=-6.28318530718, upper=6.28318530718, effort=28.0,
        velocity=6.28, damping=0.0,
        mass=0.1879, com=[0.0, 0.0771, 0.0], com_rpy=[1.57079632679, 0.0, 0.0],
        inertia=[9.89041005217e-05, 9.89041005217e-05, 0.0001321171875, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [6] ee_fixed_joint  (fixed)  wrist_3_link -> ee_link
    dict(
        name='ee_fixed_joint', type=2,
        parent=6, child=7,
        xyz=[0.0, 0.1, 0.0], rpy=[0.0, 0.0, 1.57079632679], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [7] grasptarget_hand  (fixed)  wrist_3_link -> grasptarget
    dict(
        name='grasptarget_hand', type=2,
        parent=6, child=8,
        xyz=[0.0, 0.25, 0.0], rpy=[1.57, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [8] wrist_3_link-tool0_fixed_joint  (fixed)  wrist_3_link -> tool0
    dict(
        name='wrist_3_link-tool0_fixed_joint', type=2,
        parent=6, child=9,
        xyz=[0.0, 0.09, 0.0], rpy=[-1.57079632679, -1.57079, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [9] tool_joint  (fixed)  tool0 -> robotiq_arg2f_base_link
    dict(
        name='tool_joint', type=2,
        parent=9, child=10,
        xyz=[0.0, 0.0, 0.0], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.22652, com=[8.625e-08, -4.6583e-06, 0.03145], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.00020005, 0.00017832, 0.00013478, -4.2442e-10, -2.9069e-10, -3.4402e-08],  # ixx iyy izz ixy ixz iyz
    ),
    # [10] robotiq_2f_85_left_driver_mimic_joint  (revolute)  robotiq_arg2f_base_link -> robotiq_2f_85_left_driver
    dict(
        name='robotiq_2f_85_left_driver_mimic_joint', type=0,
        parent=10, child=11,
        xyz=[0.0, -0.0306011, 0.054904], rpy=[0.0, 0.0, 3.14159265359], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.8, effort=1000.0,
        velocity=2.0, damping=0.0,
        mass=0.00853198276973456, com=[-0.000200000000003065, 0.0199435877845359, 0.0292245259211331], com_rpy=[0.0, 0.0, 0.0],
        inertia=[2.89328108496468e-06, 1.86719750325683e-06, 1.21905238907251e-06, -1.57935047237397e-19, -1.93980378593255e-19, -1.21858577871576e-06],  # ixx iyy izz ixy ixz iyz
    ),
    # [11] robotiq_2f_85_left_coupler_joint  (fixed)  robotiq_2f_85_left_driver -> robotiq_2f_85_left_coupler
    dict(
        name='robotiq_2f_85_left_coupler_joint', type=2,
        parent=11, child=12,
        xyz=[0.0, 0.0315, -0.0041], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [12] robotiq_2f_85_left_spring_link_joint  (revolute)  robotiq_arg2f_base_link -> robotiq_2f_85_left_spring_link
    dict(
        name='robotiq_2f_85_left_spring_link_joint', type=0,
        parent=10, child=13,
        xyz=[0.0, -0.0127, 0.06142], rpy=[0.0, 0.0, 3.14159265359], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.8, effort=1000.0,
        velocity=2.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [13] robotiq_2f_85_right_driver_mimic_joint  (revolute)  robotiq_arg2f_base_link -> robotiq_2f_85_right_driver
    dict(
        name='robotiq_2f_85_right_driver_mimic_joint', type=0,
        parent=10, child=14,
        xyz=[0.0, 0.0306011, 0.054904], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.8, effort=1000.0,
        velocity=2.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [14] robotiq_2f_85_right_coupler_joint  (fixed)  robotiq_2f_85_right_driver -> robotiq_2f_85_right_coupler
    dict(
        name='robotiq_2f_85_right_coupler_joint', type=2,
        parent=14, child=15,
        xyz=[0.0, 0.0315, -0.0041], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [15] robotiq_2f_85_right_spring_link_joint  (revolute)  robotiq_arg2f_base_link -> robotiq_2f_85_right_spring_link
    dict(
        name='robotiq_2f_85_right_spring_link_joint', type=0,
        parent=10, child=16,
        xyz=[0.0, 0.0127, 0.06142], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.8, effort=1000.0,
        velocity=2.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [16] coupler_joint  (fixed)  tool0 -> robotiq_ur_coupler
    dict(
        name='coupler_joint', type=2,
        parent=9, child=17,
        xyz=[0.0, 0.0, -0.0075], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.3, com=[0.0, 0.0, 0.00695], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.110299, 0.110299, 0.2109375, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [17] robotiq_ur_coupler_robotiq_2f_85_base_joint  (fixed)  robotiq_ur_coupler -> robotiq_2f_85_base
    dict(
        name='robotiq_ur_coupler_robotiq_2f_85_base_joint', type=2,
        parent=17, child=18,
        xyz=[0.0, 0.0, 0.0], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.01, com=[0.0, 0.0, 0.0075], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.00020005, 0.00017832, 0.00013478, -4.2442e-10, -2.9069e-10, -3.4402e-08],  # ixx iyy izz ixy ixz iyz
    ),
    # [18] robotiq_2f_85_left_driver_joint  (prismatic)  robotiq_2f_85_base -> robotiq_2f_85_left_pad
    dict(
        name='robotiq_2f_85_left_driver_joint', type=1,
        parent=18, child=19,
        xyz=[3.35276e-08, -0.0461303, 0.137834], rpy=[0.0, 0.0, 3.14], axis=[8.31983143e-08, -0.952063817, 0.305899474],
        lower=0.0, upper=0.0448, effort=1000.0,
        velocity=2.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [19] robotiq_2f_85_left_pad_joint  (fixed)  robotiq_2f_85_left_pad -> robotiq_2f_85_left_follower
    dict(
        name='robotiq_2f_85_left_pad_joint', type=2,
        parent=19, child=20,
        xyz=[0.0, 0.0220203446692936, -0.03242], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [20] robotiq_2f_85_right_driver_joint  (prismatic)  robotiq_2f_85_base -> robotiq_2f_85_right_pad
    dict(
        name='robotiq_2f_85_right_driver_joint', type=1,
        parent=18, child=21,
        xyz=[3.35276e-08, 0.0461303, 0.137834], rpy=[0.0, 0.0, 0.0], axis=[8.31388445e-08, -0.952019331, 0.306037896],
        lower=0.0, upper=0.0448, effort=1000.0,
        velocity=2.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [21] robotiq_2f_85_right_pad_joint  (fixed)  robotiq_2f_85_right_pad -> robotiq_2f_85_right_follower
    dict(
        name='robotiq_2f_85_right_pad_joint', type=2,
        parent=21, child=22,
        xyz=[0.0, 0.0220203446692936, -0.03242], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.0, 0.0, 0.0, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
]

ROOT_INERTIAL = dict(mass=4.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0], inertia=[0.00443333156, 0.00443333156, 0.0072, 0.0, 0.0, 0.0])
