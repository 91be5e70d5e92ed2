"""Port graph parse and weight bridge, held against the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.graph import parse_graph as jax_parse_graph
from mafyolo_tpu.models.reparam import fold_variables
from mafyolo_tpu.models.zoo import MODEL_ZOO as JAX_ZOO
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.graph import parse_graph
from mafyolo_tpu_torch.models.zoo import MODEL_ZOO
from mafyolo_tpu_torch.utils.bridge import (folded_to_state_dict,
                                            random_folded_variables)
from torch_common import port_specs

GRAPHS = ["maf-yolo-n", "maf-yolo-s", "maf-yolo-m"]


@pytest.mark.parametrize("name", GRAPHS)
def test_parse_graph_equals_jax(name):
    assert MODEL_ZOO[name] == JAX_ZOO[name]
    specs, save, out_frm = parse_graph(MODEL_ZOO[name], nc=80)
    j_specs, j_save, j_out = jax_parse_graph(JAX_ZOO[name], nc=80)
    assert save == j_save and out_frm == j_out
    assert [(s.idx, s.frm, s.kind, s.kwargs, s.cout) for s in specs] == \
        [(s.idx, s.frm, s.kind, s.kwargs, s.cout) for s in j_specs]


def _jax_folded_tree(name, nc):
    """The JAX fold of a train-form tree of ones (shapes from eval_shape:
    no full-model init is computed)."""
    m = jax_build_model(name, nc=nc)
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 64, 64, 3)), train=False))
    ones = jax.tree.map(lambda s: np.ones(s.shape, np.float32), shapes)
    return m.specs, fold_variables(m.specs, ones)


def _leaf_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.shape(v)
    return out


@pytest.mark.parametrize("name", GRAPHS)
def test_bridge_covers_every_parameter(name):
    """The JAX fold's tree maps onto the whole deploy state_dict, shapes
    matching; random_folded_variables builds exactly that tree."""
    specs, folded = _jax_folded_tree(name, nc=7)
    model = build_model(name, nc=7, deploy=True)
    sd = folded_to_state_dict(folded)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    model.load_state_dict(sd, strict=True)
    rand = random_folded_variables(port_specs(name, 7), seed=0)
    assert _leaf_shapes(rand) == _leaf_shapes(folded)


def test_random_folded_variables_nonzero_and_seeded():
    specs = port_specs("maf-yolo-n", 7)
    a = random_folded_variables(specs, seed=3)
    b = random_folded_variables(specs, seed=3)
    head = a["params"]["net"]["layer31"]
    for leaf in ("kernel", "bias"):
        assert np.all(head["cls_pred"][leaf] != 0)
        assert np.all(head["reg_pred"][leaf] != 0)
    np.testing.assert_array_equal(
        a["params"]["net"]["layer0"]["fused"]["conv"]["kernel"],
        b["params"]["net"]["layer0"]["fused"]["conv"]["kernel"])


def test_bridge_transposes_hwio_to_oihw():
    specs = port_specs("maf-yolo-n", 7)
    folded = random_folded_variables(specs, seed=1)
    sd = folded_to_state_dict(folded)
    k = folded["params"]["net"]["layer2"]["m0"]["dw"]["fused"]["conv"]["kernel"]
    w = sd["net.layer2.m0.dw.fused.conv.weight"].numpy()
    assert k.shape == (3, 3, 1, 72) and w.shape == (72, 1, 3, 3)
    np.testing.assert_array_equal(w[5, 0, 1, 2], k[1, 2, 0, 5])
