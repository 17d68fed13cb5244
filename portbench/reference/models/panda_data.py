"""Baked kinematic/inertial tables, copied verbatim from
roboticsplayroompybullet_tpu/models/panda_data.py (generated there by
tools/extract_urdf.py from the reference URDF
roboticsPlayroomPybullet/envs/franka_panda/panda.urdf; joint indexing mirrors
PyBullet's depth-first file-order convention, so joint i here ==
bullet joint i). DO NOT EDIT BY HAND."""

ROOT_LINK = 'panda_link0'
LINK_NAMES = ['panda_link0', 'panda_link1', 'panda_link2', 'panda_link3', 'panda_link4', 'panda_link5', 'panda_link6', 'panda_link7', 'panda_link8', 'panda_hand', 'panda_leftfinger', 'panda_rightfinger', 'panda_grasptarget']

# One row per joint/child-link (bullet joint index order).
# type: 0=revolute 1=prismatic 2=fixed
JOINTS = [
    # [0] panda_joint1  (revolute)  panda_link0 -> panda_link1
    dict(
        name='panda_joint1', type=0,
        parent=0, child=1,
        xyz=[0.0, 0.0, 0.333], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-2.9671, upper=2.9671, effort=87.0,
        velocity=2.175, damping=0.0,
        mass=2.7, com=[0.0, -0.04, -0.05], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [1] panda_joint2  (revolute)  panda_link1 -> panda_link2
    dict(
        name='panda_joint2', type=0,
        parent=1, child=2,
        xyz=[0.0, 0.0, 0.0], rpy=[-1.57079632679, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-1.8326, upper=1.8326, effort=87.0,
        velocity=2.175, damping=0.0,
        mass=2.73, com=[0.0, -0.04, 0.06], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [2] panda_joint3  (revolute)  panda_link2 -> panda_link3
    dict(
        name='panda_joint3', type=0,
        parent=2, child=3,
        xyz=[0.0, -0.316, 0.0], rpy=[1.57079632679, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-2.9671, upper=2.9671, effort=87.0,
        velocity=2.175, damping=0.0,
        mass=2.04, com=[0.01, 0.01, -0.05], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [3] panda_joint4  (revolute)  panda_link3 -> panda_link4
    dict(
        name='panda_joint4', type=0,
        parent=3, child=4,
        xyz=[0.0825, 0.0, 0.0], rpy=[1.57079632679, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-3.1416, upper=0.0, effort=87.0,
        velocity=2.175, damping=0.0,
        mass=2.08, com=[-0.03, 0.03, 0.02], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [4] panda_joint5  (revolute)  panda_link4 -> panda_link5
    dict(
        name='panda_joint5', type=0,
        parent=4, child=5,
        xyz=[-0.0825, 0.384, 0.0], rpy=[-1.57079632679, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-2.9671, upper=2.9671, effort=12.0,
        velocity=2.61, damping=0.0,
        mass=3.0, com=[0.0, 0.04, -0.12], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [5] panda_joint6  (revolute)  panda_link5 -> panda_link6
    dict(
        name='panda_joint6', type=0,
        parent=5, child=6,
        xyz=[0.0, 0.0, 0.0], rpy=[1.57079632679, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-0.0873, upper=3.8223, effort=12.0,
        velocity=2.61, damping=0.0,
        mass=1.3, com=[0.04, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [6] panda_joint7  (revolute)  panda_link6 -> panda_link7
    dict(
        name='panda_joint7', type=0,
        parent=6, child=7,
        xyz=[0.088, 0.0, 0.0], rpy=[1.57079632679, 0.0, 0.0], axis=[0.0, 0.0, 1.0],
        lower=-2.9671, upper=2.9671, effort=12.0,
        velocity=2.61, damping=0.0,
        mass=0.2, com=[0.0, 0.0, 0.08], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [7] panda_joint8  (fixed)  panda_link7 -> panda_link8
    dict(
        name='panda_joint8', type=2,
        parent=7, child=8,
        xyz=[0.0, 0.0, 0.107], rpy=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [8] panda_hand_joint  (fixed)  panda_link8 -> panda_hand
    dict(
        name='panda_hand_joint', type=2,
        parent=8, child=9,
        xyz=[0.0, 0.0, 0.0], rpy=[0.0, 0.0, -0.785398163397], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.81, com=[0.0, 0.0, 0.04], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [9] panda_finger_joint1  (prismatic)  panda_hand -> panda_leftfinger
    dict(
        name='panda_finger_joint1', type=1,
        parent=9, child=10,
        xyz=[0.0, 0.0, 0.0584], rpy=[0.0, 0.0, 0.0], axis=[0.0, 1.0, 0.0],
        lower=0.0, upper=0.04, effort=20.0,
        velocity=0.2, damping=0.0,
        mass=0.1, com=[0.0, 0.01, 0.02], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [10] panda_finger_joint2  (prismatic)  panda_hand -> panda_rightfinger
    dict(
        name='panda_finger_joint2', type=1,
        parent=9, child=11,
        xyz=[0.0, 0.0, 0.0584], rpy=[0.0, 0.0, 0.0], axis=[0.0, -1.0, 0.0],
        lower=0.0, upper=0.04, effort=20.0,
        velocity=0.2, damping=0.0,
        mass=0.1, com=[0.0, -0.01, 0.02], com_rpy=[0.0, 0.0, 0.0],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
    # [11] panda_grasptarget_hand  (fixed)  panda_hand -> panda_grasptarget
    dict(
        name='panda_grasptarget_hand', type=2,
        parent=9, child=12,
        xyz=[0.0, 0.0, 0.105], rpy=[0.0, 0.0, 0.0], axis=[1.0, 0.0, 0.0],
        lower=0.0, upper=0.0, effort=0.0,
        velocity=0.0, damping=0.0,
        mass=0.0, com=[0.0, 0.0, 0.0], com_rpy=[3.14, 0.0, -1.57],
        inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0],  # ixx iyy izz ixy ixz iyz
    ),
]

ROOT_INERTIAL = dict(mass=2.9, com=[0.0, 0.0, 0.05], com_rpy=[0.0, 0.0, 0.0], inertia=[0.1, 0.1, 0.1, 0.0, 0.0, 0.0])
