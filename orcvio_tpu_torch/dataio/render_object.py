"""The canonical car of the object layer: its 12 semantic keypoints.

Counterpart of ``orcvio_tpu/dataio/render_object.py``'s keypoint model
(config/object_feat_kitti.yaml object_keypoints_mean: 4 roof corners,
front and rear lights, 4 wheels; metres, z up, y forward). The synthetic
object world and the class mean shape use it; the renderer that trains and
drives the keypoint network is not part of the port yet.
"""
from __future__ import annotations

import numpy as np

CAR_KEYPOINTS = np.array([
    [-0.568, -0.253, 1.331], [0.568, -0.253, 1.331],   # roof rear L/R
    [0.482, 1.570, 1.331], [-0.482, 1.570, 1.331],     # roof front R/L
    [-0.582, -1.988, 0.702], [0.582, -1.988, 0.702],   # rear lights L/R
    [0.702, 1.961, 0.924], [-0.702, 1.961, 0.924],     # head lights R/L
    [-0.805, -1.286, 0.329], [-0.805, 1.355, 0.329],   # wheels L rear/front
    [0.805, -1.286, 0.329], [0.805, 1.355, 0.329],     # wheels R rear/front
])
