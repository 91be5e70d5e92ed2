"""Process-aware logging plus yaml helpers (counterpart of
mafyolo_tpu/utils/events.py:1-43).

`yaml` is imported inside the two helpers that use it: the card's machine has
no PyYAML, and the eval path must import there."""
import logging
import os
import sys


def _is_main_process() -> bool:
    return int(os.environ.get("RANK", "0")) in (-1, 0)


def set_logging(name: str = "mafyolo_tpu_torch"):
    level = logging.INFO if _is_main_process() else logging.WARNING
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = False
    return logger


LOGGER = set_logging()


def load_yaml(path):
    """Load a dataset/model yaml."""
    import yaml
    with open(path, errors="ignore") as f:
        return yaml.safe_load(f)


def save_yaml(obj, path):
    import yaml
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False)
