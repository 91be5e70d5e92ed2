from mafyolo_tpu_torch.models.graph import build_model  # noqa: F401
