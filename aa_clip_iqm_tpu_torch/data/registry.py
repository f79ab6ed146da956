"""Dataset registry: paths, class lists, descriptive names, domains, prompts.

Counterpart of ``aa_clip_iqm_tpu/data/registry.py``: each dataset's data
directory (relative to ``$AACLIP_DATA_ROOT`` or ``./data``), per-class
descriptive "real names" for the prompt engine, its domain
(Industrial|Medical, which selects the blur kernel), the prompt templates,
the CLIP normalization statistics and the JSONL metadata files (this
package's own copy under ``data/metadata``). Class order matches the
reference so per-class tables align.
"""
from __future__ import annotations

import os

DATA_ROOT = os.environ.get("AACLIP_DATA_ROOT", "./data")

# name -> (relative data dir, domain, {class: real name})
DATASETS = {
    "MVTec": {
        "path": "MVTec-AD",
        "domain": "Industrial",
        "classes": {
            "bottle": "dark bottle",
            "cable": "top view of three cables",
            "capsule": "black and orange capsule",
            "carpet": "gray carpet",
            "grid": "metal or plastic mesh",
            "hazelnut": "single brown hazelnut",
            "leather": "brown leather",
            "metal_nut": "metal nut which has four notched edges",
            "pill": (
                "oval white pill with small red speckles and the letters "
                "'FF' engraved"
            ),
            "screw": "screw",
            "tile": "speckled tile surface",
            "transistor": "a three-legged transistor placed vertically",
            "toothbrush": "toothbrush head",
            "wood": "wood surface",
            "zipper": "a black zipper",
        },
    },
    "VisA": {
        "path": "VisA_20220922",
        "domain": "Industrial",
        "classes": {
            "candle": "candle",
            "pcb3": "infrared sensor pcb module",
            "capsules": "capsules",
            "pipe_fryum": "pipe-shaped fryum",
            "pcb4": "battery charging pcb module",
            "macaroni2": "scattered yellow macaroni",
            "pcb2": "integrated circuits board",
            "chewinggum": "chewing gum",
            "macaroni1": "orange macaroni",
            "cashew": "cashew nut",
            "fryum": "wheel-shaped fryum snack",
            "pcb1": "dual ultrasonic distance sensor pcb module",
        },
    },
    "MPDD": {
        "path": "MPDD",
        "domain": "Industrial",
        "classes": {
            "connector": "metal clamps with black adjustment knobs",
            "tubes": "scattered metal objects",
            "metal_plate": "blue rectangular metal plate with a notch on one side",
            "bracket_white": (
                "white, elongated triangular metal bracket with a smooth, "
                "matte finish"
            ),
            "bracket_brown": (
                "brown L-shaped metal bracket with smooth, glossy finish and "
                "multiple mounting holes along its arms"
            ),
            "bracket_black": (
                "black ornamental metal bracket with spiral design attached "
                "to a rectangular frame"
            ),
        },
    },
    "BTAD": {
        "path": "BTech_Dataset_transformed",
        "domain": "Industrial",
        "classes": {
            "01": (
                "Bright concentric rings in neon yellow and blue tones against "
                "a dark blue background, resembling a stylized wave or energy "
                "field radiating outward."
            ),
            "02": "vertical fabric lines in warm, dusty pink and beige tones",
            "03": "oval concentric circular rings in gradient shades of blue and white",
        },
    },
    "Brain": {
        "path": "MedAD/Brain_AD",
        "domain": "Medical",
        "classes": {"Brain": "scan"},
    },
    "Liver": {
        "path": "MedAD/Liver_AD",
        "domain": "Medical",
        "classes": {"Liver": "scan"},
    },
    "Retina": {
        "path": "MedAD/Retina_RESC_AD",
        "domain": "Medical",
        "classes": {"Retina": "scan"},
    },
    "Colon_clinicDB": {
        "path": "Colon/CVC-ClinicDB",
        "domain": "Medical",
        "classes": {"Colon_clinicDB": "colon endoscopy image"},
    },
    "Colon_colonDB": {
        "path": "Colon/CVC-ColonDB",
        "domain": "Medical",
        "classes": {"Colon_colonDB": "colon endoscopy image"},
    },
    "Colon_cvc300": {
        "path": "Colon/CVC-300",
        "domain": "Medical",
        "classes": {"CVC-300": "colon endoscopy image"},
    },
    "Colon_Kvasir": {
        "path": "Colon/Kvasir",
        "domain": "Medical",
        "classes": {"Kvasir": "colon endoscopy image"},
    },
}

PROMPTS = {
    "normal": ["{}", "a {}", "the {}"],
    "abnormal": [
        "a damaged {}",
        "a broken {}",
        "a {} with flaw",
        "a {} with defect",
        "a {} with damage",
    ],
    "templates": ["{}.", "a photo of {}."],
}

DATA_PATH = {name: os.path.join(DATA_ROOT, d["path"]) for name, d in DATASETS.items()}
DOMAINS = {name: d["domain"] for name, d in DATASETS.items()}
CLASS_NAMES = {name: list(d["classes"].keys()) for name, d in DATASETS.items()}
REAL_NAMES = {name: dict(d["classes"]) for name, d in DATASETS.items()}

# CLIP preprocessing statistics.
IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def metadata_path(dataset_name: str, shot: int = -1, metadata_root=None) -> str:
    """JSONL metadata path, reference layout. Root precedence: explicit arg >
    $AACLIP_METADATA_ROOT > the packaged metadata/."""
    root = (metadata_root or os.environ.get("AACLIP_METADATA_ROOT")
            or os.path.join(os.path.dirname(__file__), "metadata"))
    fname = f"{shot}-shot.jsonl" if shot > 0 else "full-shot.jsonl"
    return os.path.join(root, dataset_name, fname)
