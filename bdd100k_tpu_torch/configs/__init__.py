from bdd100k_tpu_torch.configs.detector_configs import (
    BDD100K_CLASSES,
    SSD_MOBILENET_300,
    YOLO_MOBILENET_384,
    DetectorConfig,
    PostprocessConfig,
    apply_yolo_priors,
    get_config,
    tiny_test_config,
)
from bdd100k_tpu_torch.configs.train_configs import TrainConfig

__all__ = [
    "BDD100K_CLASSES",
    "SSD_MOBILENET_300",
    "YOLO_MOBILENET_384",
    "DetectorConfig",
    "PostprocessConfig",
    "TrainConfig",
    "apply_yolo_priors",
    "get_config",
    "tiny_test_config",
]
