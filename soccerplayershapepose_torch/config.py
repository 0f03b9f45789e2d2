"""Constants of the ported stages, copied from the JAX package's config.

Kept as a copy (not an import) so the port never imports the JAX package; a
test asserts every name here equals its JAX counterpart.
"""

from __future__ import annotations

FOCAL_LENGTH = 5000.0
REGRESSOR_IMG_WH = 256          # joints2D loss normalisation size
PROXY_REP_INPUT_WH = 512        # silhouettes / joints2D live in 512^2

NUM_VERTS = 6890
NUM_FACES = 13776
NUM_BETAS = 10
NUM_JOINTS = 24
NUM_BODY_JOINTS = 23
NUM_POSE_BLENDSHAPES = 9 * NUM_BODY_JOINTS
NUM_SMPL_OUTPUT_JOINTS = 45
NUM_EXTRA_JOINTS = 9
NUM_COCOPLUS_JOINTS = 19
NUM_H36M_JOINTS = 17
NUM_ALL_JOINTS = (NUM_SMPL_OUTPUT_JOINTS + NUM_EXTRA_JOINTS
                  + NUM_COCOPLUS_JOINTS + NUM_H36M_JOINTS)

SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8,
                9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)

# Vertex ids of superset joints 24..44 (face, feet, fingertips).
EXTRA_JOINT_VERTEX_IDS = (
    332, 6260, 2800, 4071, 583,
    3216, 3226, 3387, 6617, 6624, 6787,
    2746, 2319, 2445, 2556, 2673,
    6191, 5782, 5905, 6016, 6133,
)

SMPL_TO_KPRCNN_MAP = (24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21,
                      1, 2, 4, 5, 7, 8)
ALL_JOINTS_TO_COCO_MAP = (24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21,
                          1, 2, 4, 5, 7, 8)
NUM_KPRCNN_JOINTS = 17

HEATMAP_STD = 4                 # Gaussian sigma in px; truncated at 2·sigma

# Hands and feet ends stay frozen during fitting.
FITTING_FROZEN_BODY_JOINTS = (6, 7, 21, 22)
FITTING_TRAINABLE_BODY_JOINTS = tuple(
    j for j in range(NUM_BODY_JOINTS) if j not in FITTING_FROZEN_BODY_JOINTS)

SINGLE_VIEW_ITERS = 100
FITTING_LR = 0.001
FITTING_INIT_LOSS_WEIGHTS = {"joints2D": 1.0, "silhouette": 1000000.0}
MAX_PLAYERS_PER_FRAME = 22

# The detector's operating point (score ≥ 0.7, person class) and the border
# grown around a player's box before it is squared into a crop.
DETECTION_SCORE_THRESH = 0.7
PLAYER_CROP_BORDER = 40
