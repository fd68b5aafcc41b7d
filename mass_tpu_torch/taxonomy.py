"""Object-class taxonomy for AI2-THOR rearrangement.

The 54-class contract (1 OccupiedSpace + 43 pickable + 10 openable) with
the fixed segmentation colors used by the THOR dataset tooling — data
constants mirrored from the reference so maps, detectors, and metrics
interoperate (reference: mass/thor/segmentation_config.py:43-117; the
colors were originally harvested from THOR via get_color_mappings.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

PICKABLE_TO_COLOR: Dict[str, Tuple[int, int, int]] = {
    "Candle": (233, 102, 178), "SoapBottle": (168, 222, 137),
    "ToiletPaper": (162, 204, 152), "SoapBar": (43, 97, 155),
    "SprayBottle": (89, 126, 121), "TissueBox": (98, 43, 249),
    "DishSponge": (166, 58, 136), "PaperTowelRoll": (144, 173, 28),
    "Book": (43, 31, 148), "CreditCard": (56, 235, 12),
    "Dumbbell": (45, 57, 144), "Pen": (239, 130, 152),
    "Pencil": (177, 226, 23), "CellPhone": (227, 98, 136),
    "Laptop": (20, 107, 222), "CD": (65, 112, 172),
    "AlarmClock": (184, 20, 170), "Statue": (243, 75, 41),
    "Mug": (8, 94, 186), "Bowl": (209, 182, 193),
    "TableTopDecor": (126, 204, 158), "Box": (60, 252, 230),
    "RemoteControl": (187, 19, 208), "Vase": (83, 152, 69),
    "Watch": (242, 6, 88), "Newspaper": (19, 196, 2),
    "Plate": (188, 154, 128), "WateringCan": (147, 67, 249),
    "Fork": (54, 200, 25), "PepperShaker": (5, 204, 214),
    "Spoon": (235, 57, 90), "ButterKnife": (135, 147, 55),
    "Pot": (132, 237, 87), "SaltShaker": (36, 222, 26),
    "Cup": (35, 71, 130), "Spatula": (30, 98, 242),
    "WineBottle": (53, 130, 252), "Knife": (211, 157, 122),
    "Pan": (246, 212, 161), "Ladle": (174, 98, 216),
    "Egg": (240, 75, 163), "Kettle": (7, 83, 48),
    "Bottle": (64, 80, 115),
}

OPENABLE_TO_COLOR: Dict[str, Tuple[int, int, int]] = {
    "Drawer": (155, 30, 210), "Toilet": (21, 27, 163),
    "ShowerCurtain": (60, 12, 39), "ShowerDoor": (36, 253, 61),
    "Cabinet": (210, 149, 89), "Blinds": (214, 223, 197),
    "LaundryHamper": (35, 109, 26), "Safe": (198, 238, 160),
    "Microwave": (54, 96, 202), "Fridge": (91, 156, 207),
}

CLASS_TO_COLOR: Dict[str, Tuple[int, int, int]] = {
    "OccupiedSpace": (243, 246, 208),
    **PICKABLE_TO_COLOR,
    **OPENABLE_TO_COLOR,
}

CLASS_NAMES: List[str] = list(CLASS_TO_COLOR.keys())
NUM_CLASSES: int = len(CLASS_NAMES)  # 54

ID_TO_PICKABLE: List[bool] = [n in PICKABLE_TO_COLOR for n in CLASS_NAMES]
ID_TO_OPENABLE: List[bool] = [n in OPENABLE_TO_COLOR for n in CLASS_NAMES]


def class_colors_array(normalized: bool = True) -> np.ndarray:
    """``[NUM_CLASSES, 3]`` float colors (0-1 if normalized)."""
    arr = np.asarray(list(CLASS_TO_COLOR.values()), np.float32)
    return arr / 255.0 if normalized else arr


def class_id(name: str) -> int:
    return CLASS_NAMES.index(name)
