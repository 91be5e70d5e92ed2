from mafyolo_tpu_torch.assigners.atss import atss_assign  # noqa: F401
from mafyolo_tpu_torch.assigners.tal import tal_assign  # noqa: F401
