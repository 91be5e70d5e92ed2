"""Shared pieces of the tests that hold mafyolo_tpu_torch against mafyolo_tpu.

Inputs are made with numpy from a seed and handed to both packages; f32 on
the CPU, TF32 off wherever f32 is compared.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def port_specs(name: str, nc: int):
    from mafyolo_tpu_torch.models.graph import parse_graph
    from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
    return parse_graph(MODEL_ZOO[name], nc=nc)[0]


def random_folded(name: str, nc: int, seed: int = 0):
    """Random nonzero folded deploy tree (numpy leaves) for a zoo graph."""
    from mafyolo_tpu_torch.utils.bridge import random_folded_variables
    return random_folded_variables(port_specs(name, nc), seed)


def port_model(name: str, nc: int, folded, skip_until: int = -1):
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.bridge import folded_to_state_dict
    m = build_model(name, nc=nc, deploy=True, skip_until=skip_until)
    m.load_state_dict(folded_to_state_dict(folded))
    return m.eval()


def to_jax(tree):
    import jax.numpy as jnp
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def tree_leaves(tree, prefix=()):
    """(path 'a/b/c', numpy leaf) of a nested dict of arrays, sorted by path."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def u8_images(seed: int, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def prior_head_weights(graph, nc: int, seed: int = 5):
    """utils/bridge.py:random_train_variables (every leaf nonzero; the JAX
    init zeroes the preds, which zeroes every gradient upstream of the
    heads) with the cls preds as an init leaves them, scores at the prior
    0.01 (bias -log(99)), but for kernels of 0.01 x the random ones."""
    from mafyolo_tpu_torch.models import build_model
    from mafyolo_tpu_torch.utils.bridge import random_train_variables
    variables = random_train_variables(build_model(graph, nc=nc).specs, seed=seed)

    def walk(tree, parent=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, k)
            elif parent == "cls_pred":
                tree[k] = 0.01 * v if k == "kernel" else np.full_like(v, -np.log(99.0))
    walk(variables["params"])
    return variables


def jax_aug_params(key, b, h, w, *, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
                   hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, fliplr=0.5, flipud=0.0, mosaic=0.0,
                   mixup=0.0, dy_label=5, dy_mixup=0.0):
    """The parameters JAX's device_augment draws from `key`, in the port's
    layout (data/device_aug.py:draw): its key splits replayed (one key per
    sample, split in 9)."""
    import jax
    import jax.numpy as jnp

    from mafyolo_tpu.data import device_aug as J

    def _t(x):
        return torch.from_numpy(np.array(x))

    rows = []
    for k in jax.random.split(key, b):
        ka, kh, kf1, kf2, km, kd, kb, kp, kr = jax.random.split(k, 9)
        r = {}
        if mosaic:
            r["m"], r["s"] = J._affine_matrix(ka, 2 * h, 2 * h, degrees, translate, scale,
                                              shear, out_h=h, out_w=h)
            r["donors"] = jax.random.randint(kd, (3,), 0, b)
            cxy = jnp.floor(jax.random.uniform(km, (2,), minval=0.5 * h, maxval=1.5 * h))
            r["xc"], r["yc"] = cxy[0], cxy[1]
            r["do_mo"] = jax.random.uniform(kb) < mosaic
            if mixup or dy_mixup:
                kp1, kp2, kp3 = jax.random.split(kp, 3)
                r["partner"] = jax.random.randint(kp1, (), 0, b)
                r["u_mix"] = jax.random.uniform(kp2) < mixup
                r["u_dy"] = jax.random.uniform(kp3) < dy_mixup
                r["r"] = jax.random.beta(kr, 32.0, 32.0)
        elif degrees or translate or scale or shear:
            r["m"], r["s"] = J._affine_matrix(ka, h, w, degrees, translate, scale, shear)
        if hsv_h or hsv_s or hsv_v:
            r["gains"] = jax.random.uniform(kh, (3,), minval=-1, maxval=1) \
                * jnp.array([hsv_h, hsv_s, hsv_v]) + 1.0
        r["do_lr"] = jax.random.uniform(kf1) < fliplr
        r["do_ud"] = jax.random.uniform(kf2) < flipud
        rows.append(r)
    p = {k: torch.stack([_t(r[k]) for r in rows]) for k in rows[0]}
    for k in ("donors", "partner"):
        if k in p:
            p[k] = p[k].long()
    p["dy_label"] = dy_label
    return p
