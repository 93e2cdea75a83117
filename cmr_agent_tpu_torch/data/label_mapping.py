"""Semantic label mappings (the port's own copy of the JAX package's
``data/label_mapping.py``; capability of config/label_mapping/*.yaml).

The reference ships SemanticKITTI / nuScenes-lidarseg class-id -> learning-id
YAML maps (config/label_mapping/semantic-kitti.yaml:2,72,109) which its live
path never reads (the label branch of ``__getitem__`` is commented out,
dataset/KittiDataset.py:267-270). The standard public mappings are provided
here as python constants with the same access keys.
"""

from __future__ import annotations

# SemanticKITTI raw id -> name (public dataset metadata).
SEMANTIC_KITTI_LABELS = {
    0: "unlabeled", 1: "outlier", 10: "car", 11: "bicycle", 13: "bus",
    15: "motorcycle", 16: "on-rails", 18: "truck", 20: "other-vehicle",
    30: "person", 31: "bicyclist", 32: "motorcyclist", 40: "road",
    44: "parking", 48: "sidewalk", 49: "other-ground", 50: "building",
    51: "fence", 52: "other-structure", 60: "lane-marking", 70: "vegetation",
    71: "trunk", 72: "terrain", 80: "pole", 81: "traffic-sign",
    99: "other-object", 252: "moving-car", 253: "moving-bicyclist",
    254: "moving-person", 255: "moving-motorcyclist", 256: "moving-on-rails",
    257: "moving-bus", 258: "moving-truck", 259: "moving-other-vehicle",
}

# Raw id -> learning id (19 classes + ignore 0), the standard cross-entropy map.
SEMANTIC_KITTI_LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

SEMANTIC_KITTI_LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}

SEMANTIC_KITTI_LEARNING_IGNORE = {i: (i == 0) for i in range(20)}

SEMANTIC_KITTI_SPLIT = {
    "train": [0, 1, 2, 3, 4, 5, 6, 7, 9, 10],
    "valid": [8],
    "test": [11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21],
}

# BGR colors for visualisation (subset used by the debug overlay).
SEMANTIC_KITTI_COLOR_MAP = {
    0: (0, 0, 0), 1: (0, 0, 255), 10: (245, 150, 100), 11: (245, 230, 100),
    13: (250, 80, 100), 15: (150, 60, 30), 16: (255, 0, 0),
    18: (180, 30, 80), 20: (255, 0, 0), 30: (30, 30, 255),
    31: (200, 40, 255), 32: (90, 30, 150), 40: (255, 0, 255),
    44: (255, 150, 255), 48: (75, 0, 75), 49: (75, 0, 175),
    50: (0, 200, 255), 51: (50, 120, 255), 52: (0, 150, 255),
    60: (170, 255, 150), 70: (0, 175, 0), 71: (0, 60, 135),
    72: (80, 240, 150), 80: (150, 240, 255), 81: (0, 0, 255),
    99: (255, 255, 50), 252: (245, 150, 100), 253: (200, 40, 255),
    254: (30, 30, 255), 255: (90, 30, 150), 256: (255, 0, 0),
    257: (250, 80, 100), 258: (180, 30, 80), 259: (255, 0, 0),
}

# nuScenes-lidarseg raw id -> name (public dataset metadata; the
# reference's config/label_mapping/nuscenes.yaml ``labels`` key).
NUSCENES_LABELS = {
    0: "noise", 1: "animal", 2: "human.pedestrian.adult",
    3: "human.pedestrian.child", 4: "human.pedestrian.construction_worker",
    5: "human.pedestrian.personal_mobility",
    6: "human.pedestrian.police_officer", 7: "human.pedestrian.stroller",
    8: "human.pedestrian.wheelchair", 9: "movable_object.barrier",
    10: "movable_object.debris", 11: "movable_object.pushable_pullable",
    12: "movable_object.trafficcone", 13: "static_object.bicycle_rack",
    14: "vehicle.bicycle", 15: "vehicle.bus.bendy", 16: "vehicle.bus.rigid",
    17: "vehicle.car", 18: "vehicle.construction",
    19: "vehicle.emergency.ambulance", 20: "vehicle.emergency.police",
    21: "vehicle.motorcycle", 22: "vehicle.trailer", 23: "vehicle.truck",
    24: "flat.driveable_surface", 25: "flat.other", 26: "flat.sidewalk",
    27: "flat.terrain", 28: "static.manmade", 29: "static.other",
    30: "static.vegetation", 31: "vehicle.ego",
}

# Learning id -> name for the 16-class task (``labels_16`` key).
NUSCENES_LABELS_16 = {
    0: "noise", 1: "barrier", 2: "bicycle", 3: "bus", 4: "car",
    5: "construction_vehicle", 6: "motorcycle", 7: "pedestrian",
    8: "traffic_cone", 9: "trailer", 10: "truck", 11: "driveable_surface",
    12: "other_flat", 13: "sidewalk", 14: "terrain", 15: "manmade",
    16: "vegetation",
}

# nuScenes-lidarseg raw id -> 16-class learning id (public standard).
NUSCENES_LEARNING_MAP = {
    0: 0, 1: 0, 2: 7, 3: 7, 4: 7, 5: 0, 6: 7, 7: 0, 8: 0, 9: 1, 10: 0,
    11: 0, 12: 8, 13: 0, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 19: 0,
    20: 0, 21: 6, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14,
    28: 15, 29: 0, 30: 16, 31: 0,
}


def load_label_mapping(name: str) -> dict:
    """Return the mapping dict for ``'semantic-kitti'`` or ``'nuscenes'``
    with the same keys as the reference YAMLs."""
    if name == "semantic-kitti":
        return {
            "labels": SEMANTIC_KITTI_LABELS,
            "color_map": SEMANTIC_KITTI_COLOR_MAP,
            "learning_map": SEMANTIC_KITTI_LEARNING_MAP,
            "learning_map_inv": SEMANTIC_KITTI_LEARNING_MAP_INV,
            "learning_ignore": SEMANTIC_KITTI_LEARNING_IGNORE,
            "split": SEMANTIC_KITTI_SPLIT,
        }
    if name == "nuscenes":
        return {
            "labels": NUSCENES_LABELS,
            "labels_16": NUSCENES_LABELS_16,
            "learning_map": NUSCENES_LEARNING_MAP,
        }
    raise ValueError(f"unknown label mapping {name!r}")
