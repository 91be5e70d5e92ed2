"""RepOptimizer (mafyolo_tpu_torch/solver/repopt.py) and the plain (RealVGG)
train form it trains, held against the JAX package, f32 on the CPU.

A graph with 14 plain RepVGG kernels (layers 0-13, so that JAX's sorted-key
visit order, layer10 before layer2, differs from graph order), stride-1
square ones among them (identity scales): the kernel paths in graph order,
random_scales_like, the gradient masks and the re-initialized kernels equal
JAX's bit for bit from the same generator seeds; load_scales reads a
pickle and a torch `.pt` whose LinearAddBlock modules hold the scales, as
JAX's does; the plain train form in eval mode and its fold (dense branch
only) against JAX's within 1e-5, the fold leaf for leaf."""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mafyolo_tpu.models import build_model as jax_build_model
from mafyolo_tpu.models.reparam import fold_variables as jax_fold
from mafyolo_tpu.solver import repopt as J
from mafyolo_tpu_torch.models import build_model
from mafyolo_tpu_torch.models.reparam import fold_variables
from mafyolo_tpu_torch.solver import repopt as R
from mafyolo_tpu_torch.utils.bridge import (folded_to_state_dict, random_train_variables,
                                            state_dict_to_train_variables,
                                            train_variables_to_state_dict)
from torch_common import to_jax, tree_leaves, u8_images

NC = 4
REPOPT_GRAPH = dict(
    depth_multiple=1.0, width_multiple=1.0,
    backbone=[[-1, 1, "RepVGGBlock", [8, 3, 2]], [-1, 1, "RepVGGBlock", [16, 3, 2]]]
    + [[-1, 1, "RepVGGBlock", [16, 3, 1]] for _ in range(8)]
    + [[-1, 1, "RepVGGBlock", [24, 3, 1]],
       [-1, 1, "MPRep", [32]], [-1, 1, "MPRep", [32]], [-1, 1, "MPRep", [32]]],
    neck=[],
    effidehead=[[11, 1, "Head_DepthUni", [32, 16, 3]], [12, 1, "Head_DepthUni", [32, 16, 3]],
                [13, 1, "Head_DepthUni", [32, 16, 3]], [[14, 15, 16], 1, "Out", []]])


def _setup(seed=1):
    model = build_model(REPOPT_GRAPH, nc=NC, plain_rep=True)
    variables = random_train_variables(model.specs, seed=seed, plain_rep=True)
    model.load_state_dict(train_variables_to_state_dict(variables))
    return model, variables


def _kernels(model):
    """The port's params as the JAX tree (HWIO kernels), numpy."""
    return state_dict_to_train_variables(dict(model.named_parameters()))["params"]


def test_paths_scales_masks_and_reinit_match_jax():
    model, variables = _setup()
    params = variables["params"]
    paths = R.plain_rep_kernel_paths(dict(model.named_parameters()))
    want_paths = J.plain_rep_kernel_paths(params)
    assert len(paths) == 14
    assert [p.replace(".", "/").replace("weight", "kernel") for p in paths] == want_paths
    assert sorted(want_paths) != want_paths          # sorted-key order is not graph order
    scales = R.random_scales_like(model, np.random.default_rng(3))
    want_scales = J.random_scales_like(params, np.random.default_rng(3))
    assert [len(s) for s in scales] == [len(s) for s in want_scales]
    assert sorted({len(s) for s in scales}) == [2, 3]
    for s, w in zip(scales, want_scales):
        for a, b in zip(s, w):
            np.testing.assert_array_equal(a, b)

    for reinit in (True, False):
        m, _ = _setup()
        masks = R.repopt_prepare(m, scales, np.random.default_rng(7), reinit=reinit)
        new_params, mask_tree = J.repopt_prepare(to_jax(params), want_scales,
                                                 np.random.default_rng(7), reinit=reinit)
        got = dict(tree_leaves(_kernels(m)))
        for k, w in tree_leaves(jax.tree.map(np.asarray, new_params)):
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        want_masks = dict(tree_leaves(jax.tree.map(np.asarray, mask_tree)))
        assert len(masks) == 14
        for name, mask in masks.items():
            key = name.replace(".", "/").replace("weight", "kernel")
            np.testing.assert_array_equal(mask.numpy().transpose(2, 3, 1, 0), want_masks[key])
        unmasked = set(want_masks) - {n.replace(".", "/").replace("weight", "kernel")
                                      for n in masks}
        assert all((want_masks[k] == 1).all() for k in unmasked)
    with pytest.raises(ValueError, match="scale tuples"):
        R.repopt_prepare(_setup()[0], scales[:-1], np.random.default_rng(0))


class LinearAddBlock(nn.Module):
    """The hyper-search block's scale layout (its name is what load_scales
    looks for)."""

    def __init__(self, c, identity):
        super().__init__()
        self.scale_conv = nn.Conv2d(c, c, 1, bias=False, groups=c)
        self.scale_1x1 = nn.Conv2d(c, c, 1, bias=False, groups=c)
        if identity:
            self.scale_identity = nn.Conv2d(c, c, 1, bias=False, groups=c)


def test_load_scales_reads_pickle_and_pt_as_jax(tmp_path):
    torch.manual_seed(0)
    tree = nn.Sequential(nn.Sequential(LinearAddBlock(8, False), nn.ReLU()),
                         LinearAddBlock(16, True), nn.Sequential(LinearAddBlock(16, True)))
    pt = str(tmp_path / "search.pt")
    torch.save({"model": tree}, pt)
    got, want = R.load_scales(pt), J.load_scales(pt)
    assert [len(s) for s in got] == [2, 3, 3]
    for s, w in zip(got, want):
        for a, b in zip(s, w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1][0], tree[1].scale_identity.weight.detach().numpy())
    model, _ = _setup()
    scales = R.random_scales_like(model, np.random.default_rng(4))
    pk = str(tmp_path / "scales.pkl")
    with open(pk, "wb") as f:
        pickle.dump(scales, f)
    for s, w in zip(R.load_scales(pk), J.load_scales(pk)):
        for a, b in zip(s, w):
            np.testing.assert_array_equal(a, b)


def test_plain_rep_forward_and_fold_match_jax():
    """The plain train form (RepVGGBlock and MPRep's rep_down: the dense
    branch only) in eval mode against JAX's plain_rep model, within 1e-5;
    its fold leaf for leaf JAX's (the dense branch's conv + BN fuse), and the
    folded deploy model equal to the train form within 1e-5."""
    model, variables = _setup(seed=2)
    assert not any(k.endswith(("pw.conv.weight", "idbn.weight")) for k in model.state_dict())
    x = u8_images(4, (2, 64, 64, 3)).astype(np.float32) / 255.0
    jm = jax_build_model(REPOPT_GRAPH, nc=NC, plain_rep=True)
    want = jm.apply(to_jax(variables), jnp.asarray(x), train=False)
    got = model.eval()(torch.from_numpy(x))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    folded = fold_variables(model.specs, variables)
    want_f = dict(tree_leaves(jax_fold(jm.specs, variables)))
    got_f = dict(tree_leaves(folded))
    assert got_f.keys() == want_f.keys()
    for k, w in want_f.items():
        np.testing.assert_array_equal(got_f[k], w, err_msg=k)
    deploy = build_model(REPOPT_GRAPH, nc=NC, deploy=True)
    deploy.load_state_dict(folded_to_state_dict(folded))
    for g, w in zip(deploy.eval()(torch.from_numpy(x)), got):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                       atol=1e-5)
