from mafyolo_tpu_torch.data.datasets import DetectionDataset  # noqa: F401
from mafyolo_tpu_torch.data.loader import create_dataloader  # noqa: F401
