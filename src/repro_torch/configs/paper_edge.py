"""The paper's own five edge applications (Table II) with their published
model-zoo variants — used for the paper-faithful simulation benchmarks
(Figs 4–10).  Sizes are MB, accuracies are %, exactly as printed.

These are *simulation* entities (the paper itself evaluates via its E2C
simulator); the 10 assigned LM architectures are the *system* tenants and
get their zoo sizes from real config math instead.
"""
from __future__ import annotations

from repro_torch.core.model_zoo import ModelVariant, ModelZoo

# Table I — load/inference times on a Galaxy S20+ (ms); used to calibrate
# the simulator's load-time model and reproduced by benchmarks/table1.
TABLE1 = {
    # name: bits -> (size MB, load ms, infer ms, accuracy %)
    "InceptionV3": {32: (105, 650, 100, 78.50), 8: (24, 380, 80, 77.20)},
    "VGG16": {32: (528, 820, 52, 71.30), 8: (132, 185, 40, 70.18)},
    "MobileNetV1": {32: (89, 600, 15, 70.56), 8: (23, 192, 8, 65.70)},
    "MobileNetV2": {32: (26, 110, 10, 72.08), 8: (9, 65, 7.5, 63.70)},
    "MobileNetV3": {32: (14, 80.3, 7.80, 74.04), 8: (8, 47.45, 6.21, 71.32)},
    "MobileBERT": {32: (96, 1100, 62, 81.23), 8: (26, 890, 40, 77.08)},
}

# Table II — the five benchmarked applications and their zoos.
_TABLE2 = [
    # (app, model, [(bits, size MB, accuracy %)])
    ("face_recognition", "VGG-Face",
     [(32, 535.1, 90.2), (16, 378.8, 82.5), (8, 144.2, 71.8)]),
    ("image_classification", "VIT-base-patch16",
     [(32, 346.4, 94.5), (16, 242.2, 81.3), (8, 106.7, 72.2)]),
    ("speech_recognition", "S2T-librispeech",
     [(32, 285.2, 89.7), (16, 228.0, 77.2), (8, 78.4, 68.0)]),
    ("sentence_prediction", "Paraphrase-MiniLM-L12-v2",
     [(32, 471.3, 88.2), (16, 377.6, 81.7), (8, 98.9, 76.2)]),
    ("text_classification", "Roberta-base",
     [(32, 499.0, 91.1), (16, 392.2, 82.4), (8, 132.3, 76.6)]),
]

# The paper's edge server memory budget for NN models (MB).  A Jetson-Nano
# class device has 4 GB total; the paper contends ~5 FP32 models (~2.1 GB)
# against a smaller usable pool.  1.2 GB reproduces the paper's contention
# regime (all-FP32 residency impossible, all-INT8 residency possible).
DEFAULT_MEMORY_MB = 1200.0

# Load-time model calibrated on Table I's *large* models (VGG16 528 MB /
# 820 ms ≈ 1.6, InceptionV3 105/650 ≈ 6.2, MobileBERT 96/1100 ≈ 11.5 —
# size-weighted ≈ 2 ms/MB; small models amortize worse but matter less).
LOAD_MS_PER_MB = 2.0


def paper_zoos() -> dict[str, ModelZoo]:
    zoos = {}
    for app, model, variants in _TABLE2:
        zoos[app] = ModelZoo(
            app_name=app,
            variants=tuple(
                ModelVariant(
                    name=f"{model}-int{bits}" if bits < 32 else f"{model}-fp32",
                    bits=bits,
                    size_mb=size,
                    accuracy=acc,
                    load_ms=size * LOAD_MS_PER_MB,
                )
                for bits, size, acc in variants
            ),
        )
    return zoos


APP_NAMES = [row[0] for row in _TABLE2]
