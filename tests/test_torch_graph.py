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


# A reference-format yaml graph with the rows SimOTA and repopt users bring:
# Conv and SimConv stages and Head_simota heads (SimOTA's coupled head, raw
# cls / reg / obj maps), beside RepVGG and MPRep rows
SIMOTA_YAML = """\
depth_multiple: 1.0
width_multiple: 0.5
backbone:
  - [-1, 1, RepVGGBlock, [16, 3, 2]]
  - [-1, 1, Conv, [32, 3, 2]]
  - [-1, 1, SimConv, [32, 1, 1]]
  - [-1, 1, MPRep, [64]]
  - [-1, 1, MPRep, [64]]
  - [-1, 1, MPRep, [128]]
neck:
  - [-1, 1, SimConv, [64]]
effidehead:
  - [3, 1, Head_simota, [64]]
  - [4, 1, Head_simota, [64, 0]]
  - [6, 1, Head_simota, [64]]
  - [[7, 8, 9], 1, Out, []]
"""


@pytest.fixture
def simota_yaml(tmp_path):
    path = tmp_path / "simota.yaml"
    path.write_text(SIMOTA_YAML)
    return str(path)


def _tree_shapes(tree):
    return {k: tuple(v.shape) for k, v in _leaves(tree)}


@pytest.mark.parametrize("plain_rep", [False, True])
def test_yaml_graph_builds_as_jax(simota_yaml, plain_rep):
    """The yaml read by both packages' build_model: the same specs, and the
    train-form tree (plain or multi-branch RepVGG) leaf for leaf the JAX
    init's; random_train_variables builds exactly that tree; the folded tree
    (models/reparam.py: plain RepVGG, Conv, SimConv, Head_simota) equals
    JAX's fold of the same variables."""
    from mafyolo_tpu.models.graph import graph_from_yaml as jax_graph_from_yaml
    from mafyolo_tpu_torch.models.graph import graph_from_yaml
    from mafyolo_tpu_torch.models.reparam import fold_variables as port_fold
    from mafyolo_tpu_torch.utils.bridge import (random_train_variables,
                                                train_variables_to_state_dict)
    assert graph_from_yaml(simota_yaml) == jax_graph_from_yaml(simota_yaml)
    model = build_model(simota_yaml, nc=6, plain_rep=plain_rep)
    jm = jax_build_model(simota_yaml, nc=6, plain_rep=plain_rep)
    assert [(s.idx, s.frm, s.kind, s.kwargs, s.cout) for s in model.specs] == \
        [(s.idx, s.frm, s.kind, s.kwargs, s.cout) for s in jm.specs]
    assert {s.kind for s in model.specs} >= {"Conv", "SimConv", "Head_simota"}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3)), train=False))
    variables = random_train_variables(model.specs, seed=2, plain_rep=plain_rep)
    assert _tree_shapes(variables) == _tree_shapes(shapes)
    model.load_state_dict(train_variables_to_state_dict(variables))
    want = fold_variables(jm.specs, variables)
    got = port_fold(model.specs, variables)
    assert _tree_shapes(got) == _tree_shapes(want)
    for (k, g), (_, w) in zip(sorted(_leaves(got)), sorted(_leaves(want))):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_yaml_graph_forward_matches_jax(simota_yaml):
    """The yaml graph (Conv, SimConv and Head_simota rows) on bridged train
    weights: the train form in eval mode (BN running statistics; train
    mode at 64 px normalizes 8 values a channel at P5, too few for f32 to
    hold 1e-5) and the folded deploy form against JAX's, every (cls, reg,
    obj) map within 1e-5."""
    import torch

    from mafyolo_tpu.models.reparam import fold_variables as jax_fold
    from mafyolo_tpu_torch.utils.bridge import (folded_to_state_dict, random_train_variables,
                                                train_variables_to_state_dict)
    from torch_common import to_jax, u8_images
    x = u8_images(3, (2, 64, 64, 3)).astype(np.float32) / 255.0
    model = build_model(simota_yaml, nc=6)
    variables = random_train_variables(model.specs, seed=4)
    model.load_state_dict(train_variables_to_state_dict(variables))
    jm = jax_build_model(simota_yaml, nc=6)
    want = jm.apply(to_jax(variables), jnp.asarray(x), train=False)
    got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert len(g) == len(w) == 3
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    folded = jax_fold(jm.specs, variables)
    dm = build_model(simota_yaml, nc=6, deploy=True)
    dm.load_state_dict(folded_to_state_dict(folded))
    want = jax_build_model(simota_yaml, nc=6, deploy=True).apply(to_jax(folded), jnp.asarray(x))
    got = dm.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["MAF-YOLO-N", "maf-yolo-x"])
def test_build_model_names_and_paths(name, tmp_path):
    """A zoo name in any case builds its graph; any other name that is not a
    yaml path raises a KeyError that lists the zoo, and a missing yaml file
    is a FileNotFoundError."""
    if name.lower() in MODEL_ZOO:
        assert build_model(name).specs == build_model(name.lower()).specs
        return
    with pytest.raises(KeyError, match="maf-yolo-n"):
        build_model(name)
    with pytest.raises(FileNotFoundError):
        build_model(str(tmp_path / "missing.yaml"))

