from mafyolo_tpu_torch.models.losses.loss import detection_loss  # noqa: F401
